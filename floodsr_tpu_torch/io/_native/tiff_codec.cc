// TIFF-variant LZW codec + predictor transforms (native fast path).
//
// Native fast path for floodsr-tpu raster I/O: the reference stack delegates
// this work to GDAL's C++ core via rasterio (reference:
// floodsr/preprocessing.py:247-282); this library plays that role here.
// Exposed through ctypes (floodsr_tpu_torch/io/native.py); the pure-Python twins in
// floodsr_tpu_torch/io/tiff.py are the behavioral reference.
//
// Entry points:
//   fsr_lzw_decode / fsr_lzw_encode           one chunk (legacy ABI)
//   fsr_lzw_decode_strips                     whole striped image -> dst
//   fsr_lzw_encode_strips                     whole array -> packed strips
//   fsr_dequant_encode_{begin,wait,end}       uint16 codes -> float32 image
//                                             and its strips, one pass
//   fsr_predictor{2,3}_{undo,apply}           TIFF predictor transforms
//
// The strip entry points fold the per-strip Python loop, the predictor
// transform, and the destination assembly into one call, so a whole scene
// encodes or decodes without a Python loop per strip.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxCode = 4094;  // encoder resets before table overflows

// ---------------------------------------------------------------------------
// encoder core
//
// Performance shape: the encoder is a
// serial dependency chain — each byte's table lookup feeds the next key —
// so latency to the hash table dominates. Three structural choices:
//
//   1. 4-byte slots [key:20 | code:12] in an 8192-entry table (32 KiB,
//      L1-resident). code==0 marks an empty slot (real codes are >= 258).
//      (A 64-bit generation-stamped variant would live in L2.)
//   2. The table lives behind a thread_local POINTER (one TLS resolve per
//      call); a thread_local array pays per-access TLS addressing
//      under -fPIC. The pointer owns the table, so a codec thread's exit
//      frees it.
//   3. Byte-run fast path: flood-depth rasters are ~half exact-zero bytes
//      in long runs. Greedy LZW walks a run one serial table hit per byte;
//      the fast path recognizes the run with an 8-byte-wide scan and plays
//      the exact greedy cycle analytically (emit Z_m, insert Z_{m+1}),
//      touching the hash once per EMITTED CODE instead of once per byte.
//      The emitted stream stays byte-identical to the Python twin (pinned
//      by the differential fuzz in tests/test_io.py).
//   4. Length-2 strings live in a generation-stamped DIRECT 64K table
//      (`two`): index (w<<8)|c, no hash compute, no probing. On noisy
//      rasters (a trained SR output's wet cells) most lookups and most
//      dictionary entries are 2-byte strings, so this removes the hash's
//      collision pressure on the hot path and empties it for length>=3
//      entries. Reset bumps the generation (no 256 KiB memset per dict
//      reset; full clear only on 20-bit wrap). The stream stays
//      byte-identical.
// ---------------------------------------------------------------------------

constexpr int kHashBits = 13;
constexpr int kHashSize = 1 << kHashBits;

struct EncState {
  uint32_t slot[kHashSize];   // length>=3 strings: [key:20 | code:12]; 0 = empty
  uint32_t two[65536];        // length==2 strings: [gen:20 | code:12]
  uint32_t gen;               // current two[] generation stamp
  uint16_t run_code[256];     // code of the longest known run of byte b
  uint16_t run_len[256];      // its length (1 = just the literal)
};

thread_local std::unique_ptr<EncState> g_enc;

inline uint32_t enc_hash(uint32_t key) {
  return (key * 2654435761u) >> (32 - kHashBits);
}

inline void enc_reset(EncState* t) {
  std::memset(t->slot, 0, sizeof t->slot);
  ++t->gen;
  if (t->gen >= (1u << 20)) {  // stamp wrap: stale-gen entries could alias
    std::memset(t->two, 0, sizeof t->two);
    t->gen = 1;
  }
  for (int b = 0; b < 256; ++b) {
    t->run_code[b] = static_cast<uint16_t>(b);
    t->run_len[b] = 1;
  }
}

inline void store32be(unsigned char* p, uint32_t v) {
  v = __builtin_bswap32(v);
  std::memcpy(p, &v, 4);
}

long long lzw_encode_one(const unsigned char* src, long long src_len,
                         unsigned char* dst, long long dst_cap) {
  if (!g_enc) g_enc.reset(new EncState());  // value-init zeroes two/gen
  EncState* t = g_enc.get();
  enc_reset(t);
  uint32_t* slot = t->slot;
  uint32_t* two = t->two;
  uint32_t gen = t->gen;

  uint64_t bitbuf = 0;
  int bitcnt = 0;
  long long out_pos = 0;
  const long long safe_cap = dst_cap - 8;  // bulk flush writes 4 bytes
  // Bulk emit: accumulate into a 64-bit buffer, flush 4 bytes at a time
  // (code widths are 9-12 bits, so bitcnt never exceeds 32+12 < 64).
#define FSR_EMIT(code, cw)                                              \
  do {                                                                  \
    bitbuf = (bitbuf << (cw)) | static_cast<unsigned>(code);            \
    bitcnt += (cw);                                                     \
    if (bitcnt >= 32) {                                                 \
      if (__builtin_expect(out_pos > safe_cap, 0)) return -2;           \
      bitcnt -= 32;                                                     \
      store32be(dst + out_pos, static_cast<uint32_t>(bitbuf >> bitcnt)); \
      out_pos += 4;                                                     \
    }                                                                   \
  } while (0)

  int next_code = kFirst;
  int width = 9;
  FSR_EMIT(kClear, width);

  if (src_len == 0) {
    FSR_EMIT(kEoi, width);
  } else {
    long long i = 1;
    int w = src[0];
    bool check_run = true;  // w is a fresh literal: a run may start here
    while (i < src_len) {
      const int c = src[i];

      // ---- byte-run fast path -------------------------------------------
      // State "w is the literal c" (codes >= 256 can never equal a byte;
      // w is a literal ONLY at start / after a miss / after a fast-path
      // exit — check_run tracks that, keeping this test off the hit path):
      // greedy LZW on a run of T c's (T includes the byte held in w)
      // emits Z_m, Z_{m+1}, ... where Z_j is the code of j consecutive
      // c's, retiring m bytes and growing the chain by one per cycle.
      // Only full cycles run here; the partial tail (< current m bytes)
      // falls through to the generic loop, whose table hits walk it.
      if (check_run && w == c && i + 1 < src_len && src[i + 1] == c) {
        long long j = i;
        const uint64_t pat = 0x0101010101010101ull * static_cast<unsigned char>(c);
        while (j + 8 <= src_len) {
          uint64_t v;
          std::memcpy(&v, src + j, 8);
          if (v != pat) break;
          j += 8;
        }
        while (j < src_len && src[j] == c) ++j;
        long long T = 1 + (j - i);  // total run bytes incl. the one in w
        const long long run_end = j;
        int m = t->run_len[c];
        uint32_t zcode = t->run_code[c];
        if (T <= m) goto generic;  // tail-only run: generic hits walk it
        while (T > m) {
          FSR_EMIT(zcode, width);
          // Insert (Z_m, c) -> next_code so later generic lookups (shorter
          // runs, other contexts) see it — the decoder creates this entry
          // from the emitted stream either way. Z_1 is the literal c, so
          // the m==1 link is a length-2 string and lives in two[].
          if (zcode < 256) {
            two[(zcode << 8) | c] = (gen << 12) | static_cast<uint32_t>(next_code);
          } else {
            const uint32_t key = (zcode << 8) | c;
            uint32_t h = enc_hash(key);
            while (slot[h] & 0xFFFu) h = (h + 1) & (kHashSize - 1);
            slot[h] = (key << 12) | static_cast<uint32_t>(next_code);
          }
          zcode = static_cast<uint32_t>(next_code);
          ++next_code;
          if (next_code == (1 << width) && width < 12) ++width;
          T -= m;
          m += 1;
          if (next_code == kMaxCode) {
            FSR_EMIT(kClear, width);
            enc_reset(t);
            gen = t->gen;
            next_code = kFirst;
            width = 9;
            m = 1;
            zcode = static_cast<uint32_t>(c);
          }
        }
        t->run_len[c] = static_cast<uint16_t>(m);
        t->run_code[c] = static_cast<uint16_t>(zcode);
        // Bytes consumed from the input: all but the tail (T-1 of them
        // remain unread; one of the T is held in w).
        i = run_end - (T - 1);
        w = c;
        check_run = false;  // tail bytes are known hits; skip the rescan
        if (i >= src_len) break;
        continue;  // tail (< m run bytes) + following byte: generic path
      }

      // ---- generic byte step --------------------------------------------
    generic:
      if (w < 256) {
        // Length-2 string: direct-indexed, generation-stamped lookup.
        const uint32_t idx = (static_cast<uint32_t>(w) << 8) | c;
        const uint32_t e = two[idx];
        if ((e >> 12) == gen) {
          w = static_cast<int>(e & 0xFFFu);
          check_run = false;
          ++i;
          continue;
        }
        FSR_EMIT(w, width);
        two[idx] = (gen << 12) | static_cast<uint32_t>(next_code);
        if (w == t->run_code[c]) {
          t->run_code[c] = static_cast<uint16_t>(next_code);
          t->run_len[c] = static_cast<uint16_t>(t->run_len[c] + 1);
        }
        ++next_code;
        if (next_code == (1 << width) && width < 12) ++width;
        if (next_code == kMaxCode) {
          FSR_EMIT(kClear, width);
          enc_reset(t);
          gen = t->gen;
          next_code = kFirst;
          width = 9;
        }
        w = c;
        check_run = true;  // fresh literal: the next bytes may open a run
        ++i;
        continue;
      }
      {
        const uint32_t key = (static_cast<uint32_t>(w) << 8) | c;
        uint32_t h = enc_hash(key);
        uint32_t e = slot[h];
        if (__builtin_expect((e >> 12) == key, 1) && (e & 0xFFFu)) {
          w = static_cast<int>(e & 0xFFFu);
          check_run = false;
          ++i;
          continue;
        }
        while (e & 0xFFFu) {  // occupied by another key: linear probe
          h = (h + 1) & (kHashSize - 1);
          e = slot[h];
          if ((e >> 12) == key && (e & 0xFFFu)) {
            w = static_cast<int>(e & 0xFFFu);
            check_run = false;
            goto matched;
          }
        }
        FSR_EMIT(w, width);
        slot[h] = (key << 12) | static_cast<uint32_t>(next_code);
        // Track pure-run chain extensions for the fast path: (Z_m, c) with
        // w == current longest run of c extends that chain.
        if (w == t->run_code[c]) {
          t->run_code[c] = static_cast<uint16_t>(next_code);
          t->run_len[c] = static_cast<uint16_t>(t->run_len[c] + 1);
        }
        ++next_code;
        // Encoder is one entry ahead of the decoder; widen at 2^width.
        if (next_code == (1 << width) && width < 12) ++width;
        if (next_code == kMaxCode) {
          FSR_EMIT(kClear, width);
          enc_reset(t);
          gen = t->gen;
          next_code = kFirst;
          width = 9;
        }
        w = c;
        check_run = true;  // fresh literal: the next bytes may open a run
      }
    matched:
      ++i;
    }
    FSR_EMIT(w, width);
    // Endgame early-change: the decoder adds its deferred entry on this
    // final code (reaching next_code) and widens when that is 2^width - 1;
    // EOI must follow at the new width (mirrors the Python twin).
    if (next_code == (1 << width) - 1 && width < 12) ++width;
    FSR_EMIT(kEoi, width);
  }
#undef FSR_EMIT
  while (bitcnt > 0) {
    if (out_pos >= dst_cap) return -2;
    if (bitcnt >= 8) {
      bitcnt -= 8;
      dst[out_pos++] = static_cast<unsigned char>((bitbuf >> bitcnt) & 0xFF);
    } else {
      dst[out_pos++] = static_cast<unsigned char>((bitbuf << (8 - bitcnt)) & 0xFF);
      bitcnt = 0;
    }
  }
  return out_pos;
}

// ---------------------------------------------------------------------------
// decoder core (unchanged algorithm; see round-3 notes)
// ---------------------------------------------------------------------------

long long lzw_decode_one(const unsigned char* src, long long src_len,
                         unsigned char* dst, long long dst_cap) {
  long long off[4096];
  int len[4096];

  int next_code = kFirst;
  int width = 9;
  long long out_pos = 0;
  int prev_code = -1;
  long long prev_start = 0;
  int prev_len = 0;

  // Rolling MSB-first bit buffer.
  uint64_t bitbuf = 0;
  int bits = 0;
  long long in_pos = 0;

  for (;;) {
    while (bits < width && in_pos < src_len) {
      bitbuf = (bitbuf << 8) | src[in_pos++];
      bits += 8;
    }
    if (bits < width) break;  // stream exhausted without EOI
    bits -= width;
    const int code = static_cast<int>(bitbuf >> bits) & ((1 << width) - 1);

    if (code == kEoi) break;
    if (code == kClear) {
      next_code = kFirst;
      width = 9;
      prev_code = -1;
      continue;
    }

    const long long emit_start = out_pos;
    if (prev_code < 0) {
      if (code >= 256) return -1;
      if (out_pos >= dst_cap) return -2;
      dst[out_pos++] = static_cast<unsigned char>(code);
    } else {
      // Record the new entry FIRST: its bytes are prev emission + the first
      // byte of this emission, contiguous at prev_start. For the KwKwK case
      // (code == next_code) the entry's final byte is produced by this very
      // copy, which the forward byte loop handles.
      const bool have_entry = next_code < 4096;
      if (have_entry) {
        off[next_code] = prev_start;
        len[next_code] = prev_len + 1;
      }
      if (code < 256) {
        if (out_pos >= dst_cap) return -2;
        dst[out_pos++] = static_cast<unsigned char>(code);
      } else if (code < next_code + (have_entry ? 1 : 0) && code >= kFirst) {
        const long long src_off = off[code];
        const int n = len[code];
        if (out_pos + n > dst_cap) return -2;
        if (src_off + n <= out_pos) {
          std::memcpy(dst + out_pos, dst + src_off, static_cast<size_t>(n));
        } else {
          for (int k = 0; k < n; ++k) dst[out_pos + k] = dst[src_off + k];
        }
        out_pos += n;
      } else {
        return -1;  // corrupt: code beyond the table
      }
      if (have_entry) ++next_code;
    }
    prev_code = code;
    prev_start = emit_start;
    prev_len = static_cast<int>(out_pos - emit_start);
    // TIFF early change (libtiff convention): widen at 2^width - 1 entries.
    if (next_code == (1 << width) - 1 && width < 12) ++width;
  }
  return out_pos;
}

// ---------------------------------------------------------------------------
// predictor transforms (native little-endian sample layout)
// ---------------------------------------------------------------------------

inline uint16_t load16(const unsigned char* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
inline uint32_t load32(const unsigned char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t load64(const unsigned char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline void store16(unsigned char* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline void store32(unsigned char* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline void store64(unsigned char* p, uint64_t v) { std::memcpy(p, &v, 8); }

// Predictor 2 undo (horizontal differencing, integers): in-place wrapping
// cumulative sum along each row of `cols` samples.
int predictor2_undo_rows(unsigned char* data, long long rows, long long cols,
                         int itemsize) {
  for (long long r = 0; r < rows; ++r) {
    unsigned char* row = data + r * cols * itemsize;
    switch (itemsize) {
      case 1: {
        uint8_t acc = row[0];
        for (long long j = 1; j < cols; ++j) row[j] = acc = acc + row[j];
        break;
      }
      case 2: {
        uint16_t acc = load16(row);
        for (long long j = 1; j < cols; ++j) {
          acc = static_cast<uint16_t>(acc + load16(row + 2 * j));
          store16(row + 2 * j, acc);
        }
        break;
      }
      case 4: {
        uint32_t acc = load32(row);
        for (long long j = 1; j < cols; ++j) {
          acc += load32(row + 4 * j);
          store32(row + 4 * j, acc);
        }
        break;
      }
      case 8: {
        uint64_t acc = load64(row);
        for (long long j = 1; j < cols; ++j) {
          acc += load64(row + 8 * j);
          store64(row + 8 * j, acc);
        }
        break;
      }
      default:
        return -3;
    }
  }
  return 0;
}

// Predictor 2 apply: in-place wrapping horizontal difference (right to left).
int predictor2_apply_rows(unsigned char* data, long long rows, long long cols,
                          int itemsize) {
  for (long long r = 0; r < rows; ++r) {
    unsigned char* row = data + r * cols * itemsize;
    switch (itemsize) {
      case 1:
        for (long long j = cols - 1; j >= 1; --j) row[j] -= row[j - 1];
        break;
      case 2:
        for (long long j = cols - 1; j >= 1; --j)
          store16(row + 2 * j, static_cast<uint16_t>(load16(row + 2 * j) -
                                                     load16(row + 2 * (j - 1))));
        break;
      case 4:
        for (long long j = cols - 1; j >= 1; --j)
          store32(row + 4 * j, load32(row + 4 * j) - load32(row + 4 * (j - 1)));
        break;
      case 8:
        for (long long j = cols - 1; j >= 1; --j)
          store64(row + 8 * j, load64(row + 8 * j) - load64(row + 8 * (j - 1)));
        break;
      default:
        return -3;
    }
  }
  return 0;
}

// Predictor 3 undo (TIFF floating-point predictor): each source row is
// itemsize byte-planes in big-endian plane order, horizontally differenced.
// Undo = wrapping byte cumsum over the whole row span, then interleave
// plane b into output byte (itemsize-1-b) of each little-endian sample.
// src and dst must not alias.
int predictor3_undo_rows(const unsigned char* src, unsigned char* dst,
                         long long rows, long long cols, int itemsize,
                         unsigned char* scratch /* >= cols*itemsize */) {
  const long long row_bytes = cols * itemsize;
  for (long long r = 0; r < rows; ++r) {
    const unsigned char* in = src + r * row_bytes;
    unsigned char* out = dst + r * row_bytes;
    uint8_t acc = 0;
    for (long long k = 0; k < row_bytes; ++k) scratch[k] = acc = acc + in[k];
    for (int b = 0; b < itemsize; ++b) {
      const unsigned char* plane = scratch + static_cast<long long>(b) * cols;
      unsigned char* o = out + (itemsize - 1 - b);
      for (long long j = 0; j < cols; ++j) o[j * itemsize] = plane[j];
    }
  }
  return 0;
}

// Predictor 3 apply: split each little-endian row into big-endian-ordered
// byte planes, then horizontally difference the plane bytes (wrapping).
// src and dst must not alias.
int predictor3_apply_rows(const unsigned char* src, unsigned char* dst,
                          long long rows, long long cols, int itemsize) {
  const long long row_bytes = cols * itemsize;
  for (long long r = 0; r < rows; ++r) {
    const unsigned char* in = src + r * row_bytes;
    unsigned char* out = dst + r * row_bytes;
    for (int b = 0; b < itemsize; ++b) {
      unsigned char* plane = out + static_cast<long long>(b) * cols;
      const unsigned char* i0 = in + (itemsize - 1 - b);
      for (long long j = 0; j < cols; ++j) plane[j] = i0[j * itemsize];
    }
    uint8_t prev = out[0];
    for (long long k = 1; k < row_bytes; ++k) {
      const uint8_t cur = out[k];
      out[k] = static_cast<uint8_t>(cur - prev);
      prev = cur;
    }
  }
  return 0;
}

thread_local std::vector<unsigned char> g_scratch;

}  // namespace

extern "C" {

// ---- legacy one-chunk ABI (kept byte-identical in behavior) ---------------

long long fsr_lzw_decode(const unsigned char* src, long long src_len,
                         unsigned char* dst, long long dst_cap) {
  return lzw_decode_one(src, src_len, dst, dst_cap);
}

long long fsr_lzw_encode_bound(long long src_len) {
  // Worst case ~1.5 bytes/input byte plus control codes; be generous.
  return src_len + (src_len >> 1) + 64;
}

long long fsr_lzw_encode(const unsigned char* src, long long src_len,
                         unsigned char* dst, long long dst_cap) {
  return lzw_encode_one(src, src_len, dst, dst_cap);
}

// ---- predictor transforms --------------------------------------------------

int fsr_predictor2_undo(unsigned char* data, long long rows, long long cols,
                        int itemsize) {
  return predictor2_undo_rows(data, rows, cols, itemsize);
}

int fsr_predictor2_apply(unsigned char* data, long long rows, long long cols,
                         int itemsize) {
  return predictor2_apply_rows(data, rows, cols, itemsize);
}

int fsr_predictor3_undo(const unsigned char* src, unsigned char* dst,
                        long long rows, long long cols, int itemsize) {
  if (itemsize != 2 && itemsize != 4 && itemsize != 8) return -3;
  g_scratch.resize(static_cast<size_t>(cols) * itemsize);
  return predictor3_undo_rows(src, dst, rows, cols, itemsize, g_scratch.data());
}

int fsr_predictor3_apply(const unsigned char* src, unsigned char* dst,
                         long long rows, long long cols, int itemsize) {
  if (itemsize != 2 && itemsize != 4 && itemsize != 8) return -3;
  return predictor3_apply_rows(src, dst, rows, cols, itemsize);
}

// ---- whole-image strip batch ------------------------------------------------

// Decode `n_strips` LZW strips of a striped little-endian TIFF directly into
// the contiguous destination array, applying the predictor in place.
//
//   offsets/counts  per-strip byte ranges within `file` (count 0 = sparse
//                   strip -> zero fill, the GDAL SPARSE_OK convention)
//   out_bytes       per-strip decoded byte size (rows_in_strip * cols *
//                   itemsize); strips land back to back in `dst`
//   cols            samples per row (width * samples_per_pixel)
//   predictor       1 (none), 2 (horizontal int), 3 (float byte-split)
//
// Returns total bytes written, or <0: -1 corrupt, -2 overflow/short decode,
// -3 bad arguments, -4 strip range outside the file buffer.
static long long decode_one_strip(
    const unsigned char* file, long long file_len, long long offset,
    long long count, long long want, long long cols, int itemsize,
    int predictor, unsigned char* dst) {
  const long long row_bytes = cols * itemsize;
  const long long rows = want / row_bytes;
  if (count == 0) {  // sparse strip
    std::memset(dst, 0, static_cast<size_t>(want));
    return want;
  }
  if (offset < 0 || count < 0 || offset + count > file_len) return -4;
  if (predictor == 3) {
    // Decode planes into scratch, un-predict into dst.
    g_scratch.resize(static_cast<size_t>(want) + row_bytes);
    long long got = lzw_decode_one(file + offset, count, g_scratch.data(),
                                   want);
    if (got < 0) return got;
    if (got < want) return -2;
    const int rc = predictor3_undo_rows(g_scratch.data(), dst, rows, cols,
                                        itemsize, g_scratch.data() + want);
    if (rc < 0) return rc;
  } else {
    long long got = lzw_decode_one(file + offset, count, dst, want);
    if (got < 0) return got;
    if (got < want) return -2;
    if (predictor == 2) {
      const int rc = predictor2_undo_rows(dst, rows, cols, itemsize);
      if (rc < 0) return rc;
    } else if (predictor != 1) {
      return -3;
    }
  }
  return want;
}

long long fsr_lzw_decode_strips(
    const unsigned char* file, long long file_len, const long long* offsets,
    const long long* counts, const long long* out_bytes, long long n_strips,
    long long cols, int itemsize, int predictor, unsigned char* dst,
    long long dst_cap, int n_threads) {
  if (cols <= 0 || itemsize <= 0) return -3;
  const long long row_bytes = cols * itemsize;
  // Destination offsets: strips land back to back.
  std::vector<long long> dst_off(static_cast<size_t>(n_strips) + 1, 0);
  for (long long s = 0; s < n_strips; ++s) {
    const long long want = out_bytes[s];
    if (want < 0 || want % row_bytes != 0) return -3;
    dst_off[static_cast<size_t>(s) + 1] = dst_off[static_cast<size_t>(s)] + want;
  }
  if (dst_off[static_cast<size_t>(n_strips)] > dst_cap) return -2;

  if (n_threads > 1 && n_strips > 1) {
    const int workers =
        static_cast<int>(n_threads < n_strips ? n_threads : n_strips);
    std::vector<long long> rcs(static_cast<size_t>(n_strips), 0);
    std::vector<std::thread> threads;
    threads.reserve(workers);
    for (int t = 0; t < workers; ++t) {
      threads.emplace_back([&, t]() {
        for (long long s = t; s < n_strips; s += workers) {
          rcs[static_cast<size_t>(s)] = decode_one_strip(
              file, file_len, offsets[s], counts[s], out_bytes[s], cols,
              itemsize, predictor, dst + dst_off[static_cast<size_t>(s)]);
        }
      });
    }
    for (auto& th : threads) th.join();
    for (long long s = 0; s < n_strips; ++s) {
      if (rcs[static_cast<size_t>(s)] < 0) return rcs[static_cast<size_t>(s)];
    }
    return dst_off[static_cast<size_t>(n_strips)];
  }

  for (long long s = 0; s < n_strips; ++s) {
    const long long rc = decode_one_strip(
        file, file_len, offsets[s], counts[s], out_bytes[s], cols, itemsize,
        predictor, dst + dst_off[static_cast<size_t>(s)]);
    if (rc < 0) return rc;
  }
  return dst_off[static_cast<size_t>(n_strips)];
}

// Encode one chunk of whole rows (predictor + LZW) into dst; returns encoded
// bytes or <0.
static long long encode_chunk(const unsigned char* chunk, long long want,
                              long long cols, int itemsize, int predictor,
                              unsigned char* dst, long long dst_cap) {
  const long long row_bytes = cols * itemsize;
  if (want <= 0 || want % row_bytes != 0) return -3;
  const long long rows = want / row_bytes;
  if (predictor == 2) {
    g_scratch.resize(static_cast<size_t>(want));
    std::memcpy(g_scratch.data(), chunk, static_cast<size_t>(want));
    const int rc = predictor2_apply_rows(g_scratch.data(), rows, cols,
                                         itemsize);
    if (rc < 0) return rc;
    chunk = g_scratch.data();
  } else if (predictor == 3) {
    g_scratch.resize(static_cast<size_t>(want));
    const int rc = predictor3_apply_rows(chunk, g_scratch.data(), rows, cols,
                                         itemsize);
    if (rc < 0) return rc;
    chunk = g_scratch.data();
  } else if (predictor != 1) {
    return -3;
  }
  return lzw_encode_one(chunk, want, dst, dst_cap);
}

// Encode strip `s` of the contiguous source array into dst.
static long long encode_one_strip(
    const unsigned char* src, long long src_len, long long strip_bytes,
    long long s, long long cols, int itemsize, int predictor,
    unsigned char* dst, long long dst_cap) {
  const long long in_off = s * strip_bytes;
  const long long want = (in_off + strip_bytes <= src_len)
                             ? strip_bytes
                             : src_len - in_off;
  return encode_chunk(src + in_off, want, cols, itemsize, predictor, dst,
                      dst_cap);
}

// Encode the contiguous source array as `n_strips` LZW strips of
// `strip_bytes` each (the final strip may be short), applying the predictor.
// Encoded strips land back to back in `dst`; per-strip sizes in out_counts.
// Returns total encoded bytes or <0 (-2 dst overflow, -3 bad arguments).
//
// `n_threads > 1` encodes strips in parallel (strips are independent; each
// thread carries its own thread_local table/scratch), writing into bounded
// per-strip regions of `dst` and compacting afterwards — dst_cap must then
// be >= n_strips * (strip_bytes * 3/2 + 64). Strip payloads are
// byte-identical to the sequential path (deterministic per-strip streams).
long long fsr_lzw_encode_strips(
    const unsigned char* src, long long src_len, long long strip_bytes,
    long long n_strips, long long cols, int itemsize, int predictor,
    unsigned char* dst, long long dst_cap, long long* out_counts,
    int n_threads) {
  if (strip_bytes <= 0 || cols <= 0 || itemsize <= 0) return -3;
  if (strip_bytes % (cols * itemsize) != 0) return -3;

  if (n_threads > 1 && n_strips > 1) {
    const long long bound = strip_bytes + (strip_bytes >> 1) + 64;
    if (bound * n_strips > dst_cap) return -3;
    const int workers =
        static_cast<int>(n_threads < n_strips ? n_threads : n_strips);
    std::vector<long long> rcs(static_cast<size_t>(n_strips), 0);
    std::vector<std::thread> threads;
    threads.reserve(workers);
    for (int t = 0; t < workers; ++t) {
      threads.emplace_back([&, t]() {
        for (long long s = t; s < n_strips; s += workers) {
          rcs[static_cast<size_t>(s)] = encode_one_strip(
              src, src_len, strip_bytes, s, cols, itemsize, predictor,
              dst + s * bound, bound);
        }
      });
    }
    for (auto& th : threads) th.join();
    long long out_pos = 0;
    for (long long s = 0; s < n_strips; ++s) {
      const long long n = rcs[static_cast<size_t>(s)];
      if (n < 0) return n;
      if (out_pos != s * bound) {
        std::memmove(dst + out_pos, dst + s * bound, static_cast<size_t>(n));
      }
      out_counts[s] = n;
      out_pos += n;
    }
    return out_pos;
  }

  long long out_pos = 0;
  for (long long s = 0; s < n_strips; ++s) {
    const long long n = encode_one_strip(src, src_len, strip_bytes, s, cols,
                                         itemsize, predictor, dst + out_pos,
                                         dst_cap - out_pos);
    if (n < 0) return n;
    out_counts[s] = n;
    out_pos += n;
  }
  return out_pos;
}

// ---- one pass: dequantize and encode a whole image ---------------------------

// A whole image's finish in one pass over the codec threads: each thread takes
// the next strip from a shared counter, writes float(code) * step into `dst`
// for the strip's rows (the float32 product numpy forms for
// `codes.astype(np.float32) * np.float32(step)`), then applies the predictor
// and LZW-encodes those rows from `dst` while they are still in cache. Strip s
// lands in out[s * strip_cap, s * strip_cap + counts[s]): the same payload
// fsr_lzw_encode_strips gives for `dst` (deterministic per-strip streams).
// The caller writes strip k once fsr_dequant_encode_wait reports strips
// 0..k done, while the threads encode later strips.
struct DequantEncodePass {
  const uint16_t* codes;
  float* dst;
  long long rows, cols, strip_rows, n_strips;
  float step;
  int predictor;
  unsigned char* out;
  long long strip_cap;
  long long* counts;
  std::atomic<long long> next{0};
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv;
  std::vector<unsigned char> done;  // per strip, under mu
  long long ready = 0;              // strips 0..ready-1 are encoded, under mu
  long long error = 0;              // the first strip's failure (<0), under mu
  std::vector<std::thread> threads;
};

static void dequant_encode_worker(DequantEncodePass* p) {
  for (;;) {
    if (p->stop.load(std::memory_order_relaxed)) return;
    const long long s = p->next.fetch_add(1);
    if (s >= p->n_strips) return;
    const long long r0 = s * p->strip_rows;
    const long long r1 =
        r0 + p->strip_rows < p->rows ? r0 + p->strip_rows : p->rows;
    const uint16_t* in = p->codes + r0 * p->cols;
    float* o = p->dst + r0 * p->cols;
    const long long count = (r1 - r0) * p->cols;
    const float step = p->step;
    for (long long i = 0; i < count; ++i) o[i] = static_cast<float>(in[i]) * step;
    const long long n = encode_chunk(
        reinterpret_cast<const unsigned char*>(o),
        count * static_cast<long long>(sizeof(float)), p->cols,
        static_cast<int>(sizeof(float)), p->predictor,
        p->out + s * p->strip_cap, p->strip_cap);
    {
      std::lock_guard<std::mutex> lock(p->mu);
      p->counts[s] = n;
      p->done[static_cast<size_t>(s)] = 1;
      if (n < 0) {
        if (p->error == 0) p->error = n;
        p->stop.store(true, std::memory_order_relaxed);
      }
      while (p->ready < p->n_strips && p->done[static_cast<size_t>(p->ready)] &&
             p->counts[p->ready] >= 0) {
        ++p->ready;
      }
    }
    p->cv.notify_all();
  }
}

// Start the pass over `rows` x `cols` codes (row-major, C-contiguous, as is
// `dst`) in strips of `strip_rows` rows (the last may be short) on
// `n_threads` threads (at least one, at most one a strip). `out` holds
// `out_cap` >= n_strips * strip_cap bytes; `counts` n_strips entries.
// Predictor 1 or 3 (the float predictor). Returns the pass, or null when an
// argument is out of range (nothing is written then).
void* fsr_dequant_encode_begin(const uint16_t* codes, float* dst,
                               long long rows, long long cols, float step,
                               long long strip_rows, int predictor,
                               unsigned char* out, long long out_cap,
                               long long strip_cap, long long* counts,
                               int n_threads) {
  if (rows <= 0 || cols <= 0 || strip_rows <= 0 || strip_cap <= 0) return nullptr;
  if (predictor != 1 && predictor != 3) return nullptr;
  const long long n_strips = (rows + strip_rows - 1) / strip_rows;
  if (out_cap / strip_cap < n_strips) return nullptr;
  auto* p = new DequantEncodePass();
  p->codes = codes;
  p->dst = dst;
  p->rows = rows;
  p->cols = cols;
  p->strip_rows = strip_rows;
  p->n_strips = n_strips;
  p->step = step;
  p->predictor = predictor;
  p->out = out;
  p->strip_cap = strip_cap;
  p->counts = counts;
  p->done.assign(static_cast<size_t>(n_strips), 0);
  const long long workers =
      n_threads < 1 ? 1 : (n_threads < n_strips ? n_threads : n_strips);
  p->threads.reserve(static_cast<size_t>(workers));
  for (long long t = 0; t < workers; ++t) {
    p->threads.emplace_back(dequant_encode_worker, p);
  }
  return p;
}

// Block until strips 0..k-1 are encoded (k is clamped to the strip count).
// Returns how many leading strips are encoded (>= k), or the first failed
// strip's code (<0: -2 a strip overflowed strip_cap).
long long fsr_dequant_encode_wait(void* handle, long long k) {
  auto* p = static_cast<DequantEncodePass*>(handle);
  if (k > p->n_strips) k = p->n_strips;
  std::unique_lock<std::mutex> lock(p->mu);
  p->cv.wait(lock, [&] { return p->error < 0 || p->ready >= k; });
  return p->error < 0 ? p->error : p->ready;
}

// Stop handing out strips, join the threads and free the pass. Returns 0, or
// the first failed strip's code. Call once for every pass begun.
long long fsr_dequant_encode_end(void* handle) {
  auto* p = static_cast<DequantEncodePass*>(handle);
  p->stop.store(true, std::memory_order_relaxed);
  for (auto& th : p->threads) th.join();
  const long long error = p->error;
  delete p;
  return error;
}

}  // extern "C"
