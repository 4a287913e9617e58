// jdt_entropy.cpp — native restart-segment-parallel JPEG entropy decode.
//
// This is the TPU framework's host runtime for the one inherently serial
// stage of JPEG decoding: Huffman/entropy decode of a scan into the
// coefficient-plane IR. The reference decodes bit-by-bit, one call per
// compressed bit (`next_bit` /root/reference/src/bitstream.c:61-67) inside a
// per-MCU interleaved loop (`decode_scan` decode.c:535-663). Here:
//
//   * a 64-bit bit-buffer with inline 0xFF00 unstuffing replaces the
//     per-bit calls (refill amortized to ~7 bytes at a time);
//   * Huffman symbols resolve through a flat 16-bit-indexed LUT
//     (one lookup per symbol) instead of the <=16-step compare walk
//     (decode.c:674-681);
//   * restart segments — which the reference uses only for error resync
//     (decode.c:578-590) — are decoded CONCURRENTLY, one worker per
//     segment, since DC predictors and bit alignment reset at every RSTn;
//   * errors return codes with positions; there is no exit() anywhere
//     (the reference silently exit(1)s on malformed progressive data,
//     decode.c:861,868).
//
// Progressive scans (spec G.1.2: DC first/refine, AC first/refine with
// EOB-run accounting) use the same machinery — the reference's progressive
// path is broken and is not the model; core/oracle.py is.
//
// C ABI only (loaded via ctypes); no Python.h dependency.

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <limits>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <functional>
#include <thread>
#include <chrono>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif
#if defined(__AVX2__)
#include <immintrin.h>
#endif

// Pair-table window width: index = top (64 - JDT_PAIR_SHIFT) bits of the
// bit window. Must match core/huffman.PAIR_BITS (native/build.py passes
// -DJDT_PAIR_SHIFT=64-PAIR_BITS and folds it into the build hash). The
// kind/field extractions below (>> 52/53) are the vlut2 VALUE layout and
// do not depend on the window width.
#ifndef JDT_PAIR_SHIFT
#define JDT_PAIR_SHIFT 52
#endif

namespace {

enum JdtStatus : int32_t {
  JDT_OK = 0,
  JDT_ERR_BAD_CODE = 1,    // invalid Huffman prefix
  JDT_ERR_COEF_RANGE = 2,  // coefficient index out of range
  JDT_ERR_TRUNCATED = 3,   // ran off the end of entropy data
  JDT_ERR_BAD_ARG = 4,
  JDT_ERR_SEG_COUNT = 5,   // restart-marker count inconsistent with DRI
};

// ---------------------------------------------------------------------------
// Bit reader: 64-bit buffer, MSB-aligned, inline FF00 unstuffing.
// Segment byte bounds exclude all markers (the Python prescan guarantees
// this), so inside a segment 0xFF is always followed by a stuffed 0x00.
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* origin = nullptr;  // for position accounting
  uint64_t buf = 0;  // MSB-first: next bit is bit 63
  int nbits = 0;
  int64_t padded = 0;  // zero bytes fabricated past the end
  int64_t skips = 0;   // stuffed 0x00 bytes skipped so far

  void init(const uint8_t* start, const uint8_t* stop) {
    p = start;
    end = stop;
    origin = start;
    buf = 0;
    nbits = 0;
    padded = 0;
    skips = 0;
  }

  // Bit-cursor position in UNSTUFFED bits relative to origin (stuffed
  // zeros excluded; fabricated past-end padding counts as fetched bits) —
  // comparable across readers sharing a global unstuffed coordinate base.
  inline int64_t unstuffed_pos() const {
    return 8 * ((p - origin) - skips + padded) - nbits;
  }

  static inline bool has_ff6(uint64_t v) {
    // Any 0xFF byte among the low 6 bytes (SWAR zero-byte test on ~v).
    uint64_t x = ~(v | 0xFFFF000000000000ull);
    return ((x - 0x0101010101010101ull) & ~x & 0x8080808080808080ull) != 0;
  }

  inline void fill() {
    // Contract: on return, nbits >= 33 — enough for one Huffman code
    // (<= 16 bits) plus its extend bits (<= 16) without another refill.
    if (nbits > 32) return;
    // Fast path: bulk-insert clean bytes (no 0xFF, so no unstuffing and no
    // marker concerns) with one unaligned load — the common case for
    // high-entropy streams, ~6x fewer iterations than the byte loop.
    if (p + 8 <= end) {
      uint64_t v;
      std::memcpy(&v, p, 8);
      if (!has_ff6(v)) {
        uint64_t be = __builtin_bswap64(v);
        if (nbits <= 16) {
          buf |= (be & ~0xFFFFull) >> nbits;  // top 48 bits
          nbits += 48;
          p += 6;
        } else {
          buf |= (be & ~0xFFFFFFFFull) >> nbits;  // top 32 bits
          nbits += 32;
          p += 4;
        }
        return;
      }
    }
    while (nbits <= 56) {
      uint8_t b = 0;
      if (p < end) {
        b = *p++;
        if (b == 0xFF && p < end && *p == 0x00) {  // unstuff
          p++;
          skips++;
        }
      } else {
        padded++;
      }
      buf |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }

  inline uint32_t peek16() {
    fill();
    return static_cast<uint32_t>(buf >> 48);
  }

  inline void consume(int n) {
    buf <<= n;
    nbits -= n;
  }

  inline int32_t receive(int n) {
    if (n == 0) return 0;
    fill();
    int32_t v = static_cast<int32_t>(buf >> (64 - n));
    consume(n);
    return v;
  }

  inline int32_t bit() {
    fill();
    int32_t v = static_cast<int32_t>(buf >> 63);
    consume(1);
    return v;
  }

  // Truncation test: consuming more than the 7 possible 1-fill alignment
  // bits past the real (unstuffed) end means the stream is genuinely
  // short — matches the oracle BitReader's strictness (bitstream.py).
  inline bool overran() const {
    if (padded == 0) return false;
    int64_t real_bits = 8 * ((end - origin) - skips);
    return unstuffed_pos() > real_bits + 7;
  }
};

inline int32_t extend(int32_t v, int n) {
  // Spec F.2.2.1 EXTEND (reference decode.c:684-686).
  if (n == 0) return 0;
  if (v < (1 << (n - 1))) return v - (1 << n) + 1;
  return v;
}

// ---------------------------------------------------------------------------
// Persistent worker pool. Per-image decode previously spawned and joined
// fresh std::threads per scan (~50-100 us each); steady-state serving pays
// that on every image. The pool keeps (hardware_concurrency - 1) helpers
// parked on a condvar; run(n, fn) executes fn(0..n-1) with the CALLER
// running slot 0 and helpers picking up the rest. Concurrent run() calls
// (decode_stream can overlap host decodes) serialize on run_mutex_ — they
// would contend for the same cores anyway.
// ---------------------------------------------------------------------------
class WorkPool {
 public:
  static WorkPool& inst() {
    // Intentionally never destroyed: helpers are parked on cv_ at process
    // exit and destroying the mutex under them is UB. The static pointer
    // keeps the object reachable, so leak checkers stay quiet.
    static WorkPool* p = new WorkPool();
    return *p;
  }

  void run(int n, const std::function<void(int)>& fn) {
    if (n <= 1) {
      fn(0);
      return;
    }
    std::lock_guard<std::mutex> run_lk(run_mutex_);
    ensure(n - 1);
    {
      std::lock_guard<std::mutex> lk(m_);
      fn_ = &fn;
      want_ = n - 1;
      done_ = 0;
      epoch_++;
    }
    cv_.notify_all();
    fn(0);
    std::unique_lock<std::mutex> lk(m_);
    cv_done_.wait(lk, [&] { return done_ == want_; });
    fn_ = nullptr;
  }

 private:
  void ensure(int k) {
    while (static_cast<int>(n_threads_) < k) {
      int slot = ++n_threads_;
      std::thread([this, slot] { loop(slot); }).detach();
    }
  }

  void loop(int slot) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int)>* f = nullptr;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return epoch_ != seen; });
        seen = epoch_;
        if (slot <= want_) f = fn_;
      }
      if (f) {
        (*f)(slot);
        std::lock_guard<std::mutex> lk(m_);
        if (++done_ == want_) cv_done_.notify_one();
      }
    }
  }

  std::mutex run_mutex_;  // serializes concurrent run() callers
  std::mutex m_;
  std::condition_variable cv_, cv_done_;
  const std::function<void(int)>* fn_ = nullptr;
  int want_ = 0;
  int done_ = 0;
  uint64_t epoch_ = 0;
  int n_threads_ = 0;
};

// Run fn on `workers` slots via the persistent pool (slot 0 = caller).
inline void pool_run(int workers, const std::function<void(int)>& fn) {
  WorkPool::inst().run(workers, fn);
}

struct HuffLut {
  // Views over Python-prebuilt, content-cached decode tables
  // (core/huffman.build_flat_lut). Layouts:
  //   lut12 [4096]  u16 — codes <= 12 bits keyed by the next 12 bits;
  //                 entry = (len << 8) | symbol, 0 = "go to lut16".
  //                 8 KB: L1-resident, hits on virtually every symbol.
  //   lut16 [65536] u16 — all codes keyed by the next 16 bits; len 0 =
  //                 invalid prefix.
  //   vlut  [4096]  i32 — AC fast path: code AND extend bits resolved by
  //                 one 12-bit lookup (libjpeg-turbo-style):
  //                   [15:0]  coefficient value (int16)
  //                   [21:16] total bits consumed (code + extend)
  //                   [25:22] zero run
  //                   [27:26] kind: 0 coef, 1 EOB, 2 ZRL, 3 slow path
  //   pvlut [4096]  i32 — progressive-AC variant: kind 1 = EOBn (run in
  //                 [25:22], CODE length in [21:16]; the r extension bits
  //                 are read after); coef values are raw (decoder applies
  //                 << al).
  //   vlut2 [4096]  i64 — PAIR-resolved AC fast path: one 12-bit lookup
  //                 resolves up to TWO complete coefficient symbols (the
  //                 mean symbol is ~5 bits on high-entropy streams, so
  //                 ~3/4 of adjacent pairs fit one window). Layout
  //                 (core/huffman.build_flat_lut):
  //                   [15:0]  val1 (int16)    [31:16] val2 (int16)
  //                   [35:32] off1 = run1     [41:36] off2 = run1+1+run2
  //                   [45:42] w1 (bits sym1)  [51:46] w (bits whole entry)
  //                   [54:52] kind: 0 pair, 1 coef, 2 EOB, 3 ZRL, 4 slow,
  //                                 5 coef+EOB
  const uint16_t* lut12 = nullptr;
  const uint16_t* lut16 = nullptr;
  const int32_t* vlut = nullptr;
  const int32_t* pvlut = nullptr;
  const uint64_t* vlut2 = nullptr;
  enum { KIND_COEF = 0, KIND_EOB = 1, KIND_ZRL = 2, KIND_SLOW = 3 };
  enum { PKIND_COEF = 0, PKIND_EOBN = 1, PKIND_ZRL = 2, PKIND_SLOW = 3 };
  enum {
    K2_PAIR = 0, K2_COEF = 1, K2_EOB = 2, K2_ZRL = 3, K2_SLOW = 4,
    K2_COEF_EOB = 5,
  };

  inline int decode(BitReader& br, int32_t* sym) const {
    uint32_t idx = br.peek16();
    uint32_t e = lut12[idx >> 4];
    if (e == 0) {
      e = lut16[idx];
      if ((e >> 8) == 0) return JDT_ERR_BAD_CODE;
    }
    *sym = e & 0xFF;
    br.consume(e >> 8);
    return JDT_OK;
  }
};

// Per data-unit-in-MCU layout, 11 int32s from Python (see
// native/runtime.py _unit_params; coordinate math mirrors the block form of
// write_mcu decode.c:475-486 / oracle._block_position).
struct UnitLayout {
  int32_t plane;     // frame-component index
  int32_t scomp;     // scan-component index (DC predictor slot)
  int32_t dc_lut;    // index into luts[]
  int32_t ac_lut;
  int32_t h, v;      // effective sampling factors
  int32_t j, k;      // unit position within the MCU
  int32_t wrap;      // block-column wrap width
  int32_t plane_bw;  // plane width in blocks
  int32_t plane_bh;  // plane height in blocks
};

struct ScanContext {
  const uint8_t* data;
  const int64_t* seg_bounds;  // [2 * n_segs]
  int64_t n_segs;
  int64_t total_mcus;
  int64_t ri;
  std::vector<UnitLayout> units;
  std::vector<HuffLut> luts;
  int16_t** planes;
  // Optional stuffed-0xFF index from the prescan (offsets of each 0xFF
  // whose next byte is a stuffed 0x00, ascending, data coordinates).
  // nullptr / n_stuff < 0 -> segments re-scan with memchr as before.
  const int64_t* stuff = nullptr;
  int64_t n_stuff = -1;
};

inline int decode_du_sequential(BitReader& br, const HuffLut& dc,
                                const HuffLut& ac, int32_t* pred,
                                int16_t* du) {
  // Mirrors decode_data_unit (decode.c:665-723); writes 64 zigzag coeffs.
  // One fill() per symbol covers both the code (<=16 bits) and its extend
  // bits (<=16): after consuming the code, >=41 buffered bits remain.
  std::memset(du, 0, 64 * sizeof(int16_t));
  br.fill();
  uint32_t idx = static_cast<uint32_t>(br.buf >> 48);
  uint32_t e = dc.lut12[idx >> 4];
  if (e == 0) {
    e = dc.lut16[idx];
    if ((e >> 8) == 0) return JDT_ERR_BAD_CODE;
  }
  int s = e & 0xFF;
  br.consume(e >> 8);
  if (s > 15) return JDT_ERR_COEF_RANGE;
  if (s) {
    int32_t v = static_cast<int32_t>(br.buf >> (64 - s));
    br.consume(s);
    *pred += extend(v, s);
  }
  du[0] = static_cast<int16_t>(*pred);

  // Sentinel for "refill / bounds check needed" (real entries keep bits
  // 63:55 zero, so ~0 can never collide).
  constexpr uint64_t kNeedRefill = ~0ull;
  int i = 1;
  while (i < 64) {
    br.fill();
    // Drain the buffered bits through the PAIR-resolved table: each hit
    // resolves one or two complete coefficient symbols in <= 12 bits, so
    // decode until fewer than 12 valid bits remain — one fill() amortizes
    // over several entries, each entry averaging ~1.8 symbols. The body is
    // branchless for BOTH entry kinds: COEF entries duplicate their symbol
    // into the val2/off2 slots (core/huffman.build_flat_lut), so the
    // second store just rewrites the same coefficient and the only branch
    // left is the rare exit (kind >= K2_EOB, i.e. bits 54:53 != 0, or a
    // block boundary inside the entry) — measured ~19% faster than the
    // per-kind dispatch on the 4K q85 stream (mispredicts dominate).
    uint64_t en;
    for (;;) {
      en = ac.vlut2[static_cast<uint32_t>(br.buf >> JDT_PAIR_SHIFT)];
      int off2 = (en >> 36) & 63;
      if ((((en >> 53) & 3) != 0) | (i + off2 > 63)) break;
      du[i + ((en >> 32) & 15)] = static_cast<int16_t>(en & 0xFFFF);
      du[i + off2] = static_cast<int16_t>((en >> 16) & 0xFFFF);
      br.consume((en >> 46) & 63);
      i += off2 + 1;
      if (i >= 64 || br.nbits < 12) {
        en = kNeedRefill;
        break;
      }
    }
    if (en == kNeedRefill) continue;
    int kind = static_cast<int>(en >> 52) & 7;
    if (kind <= HuffLut::K2_COEF) {
      // Block boundary inside a PAIR/COEF entry: apply symbol 1 alone; the
      // next iteration (or the next DU's DC decode) re-reads the following
      // bits in their true context.
      i += (en >> 32) & 15;
      if (i > 63) return JDT_ERR_COEF_RANGE;
      du[i] = static_cast<int16_t>(en & 0xFFFF);
      br.consume((en >> 42) & 15);
      i++;
      continue;
    }
    if (kind == HuffLut::K2_COEF_EOB) {
      // Final coefficient + EOB resolved in one window. A coefficient
      // landing exactly at index 63 completes the block WITHOUT an EOB in
      // the stream — consume only the coefficient's bits then.
      i += (en >> 32) & 15;
      if (i > 63) return JDT_ERR_COEF_RANGE;
      du[i] = static_cast<int16_t>(en & 0xFFFF);
      br.consume(i == 63 ? (en >> 42) & 15 : (en >> 46) & 63);
      break;
    }
    if (kind == HuffLut::K2_EOB) {
      br.consume((en >> 46) & 63);
      break;
    }
    if (kind == HuffLut::K2_ZRL) {
      br.consume((en >> 46) & 63);
      i += 16;
      continue;
    }
    // Slow path: long code or long extend — full 16-bit decode. The drain
    // loop only guarantees >= 12 buffered bits; this path peeks 16 and
    // reads up to 16 extend bits, so top the buffer back up first.
    br.fill();
    idx = static_cast<uint32_t>(br.buf >> 48);
    e = ac.lut12[idx >> 4];
    if (e == 0) {
      e = ac.lut16[idx];
      if ((e >> 8) == 0) return JDT_ERR_BAD_CODE;
    }
    br.consume(e >> 8);
    int sym = e & 0xFF;
    int run = sym >> 4;
    int size = sym & 0x0F;
    i += run;
    if (sym == 0x00) break;  // EOB
    if (sym == 0xF0) {       // ZRL (15 zeros + the i++ below)
      i += 1;
      continue;
    }
    if (i > 63) return JDT_ERR_COEF_RANGE;
    if (size) {
      int32_t v = static_cast<int32_t>(br.buf >> (64 - size));
      br.consume(size);
      du[i] = static_cast<int16_t>(extend(v, size));
    }
    i++;
  }
  return br.overran() ? JDT_ERR_TRUNCATED : JDT_OK;
}

int decode_segment_sequential(const ScanContext& c, int64_t seg,
                              int64_t* err_mcu) {
  BitReader br;
  br.init(c.data + c.seg_bounds[2 * seg], c.data + c.seg_bounds[2 * seg + 1]);
  int64_t mcu_lo = c.ri ? seg * c.ri : 0;
  int64_t mcu_hi = c.ri ? std::min<int64_t>(mcu_lo + c.ri, c.total_mcus)
                        : c.total_mcus;
  int32_t preds[4] = {0, 0, 0, 0};
  int16_t scratch[64];  // sink for the rare out-of-plane blocks

  for (int64_t m = mcu_lo; m < mcu_hi; m++) {
    for (const UnitLayout& ul : c.units) {
      int64_t base = m * ul.h + ul.k;
      int64_t bx = base % ul.wrap;
      int64_t by = (base / ul.wrap) * ul.v + ul.j;
      // Decode straight into the plane (no staging buffer / memcpy).
      int16_t* du = (by < ul.plane_bh && bx < ul.plane_bw)
                        ? c.planes[ul.plane] + (by * ul.plane_bw + bx) * 64
                        : scratch;
      int rc = decode_du_sequential(br, c.luts[ul.dc_lut], c.luts[ul.ac_lut],
                                    &preds[ul.scomp], du);
      if (rc != JDT_OK) {
        *err_mcu = m;
        return rc;
      }
    }
  }
  return JDT_OK;
}

// ---------------------------------------------------------------------------
// Progressive passes (spec G.1.2; mirrors core/oracle.py, the validated
// model — NOT the reference's broken decode_progressive_scan).
// ---------------------------------------------------------------------------
struct ProgParams {
  int32_t ss, se, ah, al;
};

#if defined(__AVX2__) && defined(__BMI2__)
// Nonzero-position mask of one int16 data unit (bit k set iff coef[k]!=0).
// The AC-refinement hot walk is branch-bound without it: coef[k]!=0 is
// data-random, so the scalar loop mispredicts ~per coefficient.
static inline uint64_t refine_nz_mask(const int16_t* unit) {
  uint64_t nz = 0;
  for (int g = 0; g < 64; g += 16) {
    __m256i v16 =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(unit + g));
    uint32_t zm = static_cast<uint32_t>(_mm256_movemask_epi8(
        _mm256_cmpeq_epi16(v16, _mm256_setzero_si256())));
    uint32_t z16 = _pext_u32(zm, 0x55555555u);
    nz |= static_cast<uint64_t>(~z16 & 0xFFFFu) << g;
  }
  return nz;
}

// Apply one correction bit per set bit of `mask` (position order), batching
// the bit reads through the 64-bit window instead of one fill per bit.
static inline void refine_apply(BitReader& br, int16_t* coef, uint64_t mask,
                                int32_t p1, int32_t m1) {
  int need = __builtin_popcountll(mask);
  while (need > 0) {
    br.fill();  // contract: >= 33 bits available
    int take = need < 32 ? need : 32;
    uint32_t bits = static_cast<uint32_t>(br.buf >> (64 - take));
    br.consume(take);
    need -= take;
    for (int i = take - 1; i >= 0; i--) {
      int pos = __builtin_ctzll(mask);
      mask &= mask - 1;
      int32_t cv = coef[pos];
      // Branchless: the correction bit is ~coin-flip data, so a branch
      // here mispredicts ~per coefficient. Unconditional store (the
      // block is L1-resident).
      int32_t apply =
          static_cast<int32_t>((bits >> i) & 1u) & ((cv & p1) == 0);
      int32_t delta = cv >= 0 ? p1 : m1;
      coef[pos] = static_cast<int16_t>(cv + (apply ? delta : 0));
    }
  }
}
#endif

int decode_segment_progressive(const ScanContext& c, const ProgParams& pp,
                               int64_t seg, int64_t* err_mcu) {
  BitReader br;
  br.init(c.data + c.seg_bounds[2 * seg], c.data + c.seg_bounds[2 * seg + 1]);
  int64_t mcu_lo = c.ri ? seg * c.ri : 0;
  int64_t mcu_hi = c.ri ? std::min<int64_t>(mcu_lo + c.ri, c.total_mcus)
                        : c.total_mcus;
  int32_t preds[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  const bool is_dc = pp.ss == 0;
  const int32_t p1 = 1 << pp.al;
  const int32_t m1 = -(1 << pp.al);
  int16_t scratch[64];  // sink for out-of-bounds blocks (never hit on
                        // well-formed streams; planes are MCU-padded)

  for (int64_t m = mcu_lo; m < mcu_hi; m++) {
    for (const UnitLayout& ul : c.units) {
      int64_t base = m * ul.h + ul.k;
      int64_t bx = base % ul.wrap;
      int64_t by = (base / ul.wrap) * ul.v + ul.j;
      bool in_bounds = by < ul.plane_bh && bx < ul.plane_bw;
      int16_t* coef =
          in_bounds ? c.planes[ul.plane] + (by * ul.plane_bw + bx) * 64
                    : scratch;

      if (is_dc && pp.ah == 0) {
        int32_t s;
        int rc = c.luts[ul.dc_lut].decode(br, &s);
        if (rc != JDT_OK) { *err_mcu = m; return rc; }
        if (s > 15) { *err_mcu = m; return JDT_ERR_COEF_RANGE; }
        preds[ul.scomp] += extend(br.receive(s), s);
        coef[0] = static_cast<int16_t>(
            static_cast<uint32_t>(preds[ul.scomp]) << pp.al);
      } else if (is_dc) {
        // DC refine (G.1.2.1). The reference omits the <<al shift
        // (decode.c:1055) — that is a bug, not a parity target.
        if (br.bit()) coef[0] = static_cast<int16_t>(coef[0] | p1);
      } else if (pp.ah == 0) {
        // AC first pass (G.1.2.2) — pvlut fast path: code + extend (or
        // EOBn run) resolved per 12-bit lookup; slow path for long codes.
        if (eobrun > 0) {
          eobrun--;
        } else {
          const HuffLut& hl = c.luts[ul.ac_lut];
          int k = pp.ss;
          while (k <= pp.se) {
            br.fill();
            int32_t en = hl.pvlut[static_cast<uint32_t>(br.buf >> 52)];
            int kind = (en >> 26) & 3;
            if (kind == HuffLut::PKIND_COEF) {
              k += (en >> 22) & 0x0F;
              if (k > pp.se) { *err_mcu = m; return JDT_ERR_COEF_RANGE; }
              coef[k] = static_cast<int16_t>(
                  static_cast<uint32_t>(
                      static_cast<int16_t>(en & 0xFFFF))
                  << pp.al);
              br.consume((en >> 16) & 0x3F);
              k++;
              continue;
            }
            if (kind == HuffLut::PKIND_EOBN) {
              int run = (en >> 22) & 0x0F;
              br.consume((en >> 16) & 0x3F);
              eobrun = (1 << run) - 1;
              if (run) eobrun += br.receive(run);
              break;
            }
            if (kind == HuffLut::PKIND_ZRL) {
              br.consume((en >> 16) & 0x3F);
              k += 16;
              continue;
            }
            // Slow path: full 16-bit decode.
            int32_t s;
            int rc = hl.decode(br, &s);
            if (rc != JDT_OK) { *err_mcu = m; return rc; }
            int run = (s >> 4) & 0x0F;
            int size = s & 0x0F;
            if (size == 0) {
              if (run == 15) { k += 16; continue; }  // ZRL
              eobrun = (1 << run) - 1;
              if (run) eobrun += br.receive(run);
              break;
            }
            k += run;
            if (k > pp.se) { *err_mcu = m; return JDT_ERR_COEF_RANGE; }
            coef[k] = static_cast<int16_t>(
                static_cast<uint32_t>(extend(br.receive(size), size))
                << pp.al);
            k++;
          }
        }
      } else {
        // AC refinement pass (G.1.2.3).
#if defined(__AVX2__) && defined(__BMI2__)
        // Mask-driven form, output-identical to the scalar walk below:
        // the zero-run stop position is resolved with one pdep over the
        // block's zero-history mask, and every correction bit between is
        // read in <=32-bit batches (refine_apply) instead of one
        // data-dependent branch + fill per coefficient. Coefficients
        // inserted by THIS scan land strictly behind the walk cursor, so
        // the history mask only needs updating at the insert position.
        int k = pp.ss;
        uint64_t nz = refine_nz_mask(coef);
        const uint64_t se_mask =
            pp.se < 63 ? (2ull << pp.se) - 1 : ~0ull;
        if (eobrun == 0) {
          while (k <= pp.se) {
            int32_t s;
            int rc = c.luts[ul.ac_lut].decode(br, &s);
            if (rc != JDT_OK) { *err_mcu = m; return rc; }
            int run = (s >> 4) & 0x0F;
            int size = s & 0x0F;
            int32_t val = 0;
            if (size == 0) {
              if (run != 15) {
                eobrun = 1 << run;
                if (run) eobrun += br.receive(run);
                break;
              }
              // ZRL: skip 16 zero-history coefficients
            } else {
              if (size != 1) { *err_mcu = m; return JDT_ERR_COEF_RANGE; }
              val = br.bit() ? p1 : m1;
            }
            uint64_t range = se_mask & ~((1ull << k) - 1);
            uint64_t zeros = ~nz & range;
            // Stop bit = the (run+1)-th zero-history position in range
            // (0 when fewer zeros remain: the walk runs off se).
            uint64_t stop = _pdep_u64(1ull << run, zeros);
            uint64_t before = stop ? stop - 1 : ~0ull;
            refine_apply(br, coef, nz & range & before, p1, m1);
            if (stop == 0) {
              k = pp.se + 1;
            } else {
              k = __builtin_ctzll(stop);
              if (val != 0) {
                coef[k] = static_cast<int16_t>(val);
                nz |= 1ull << k;
              }
              k++;
            }
          }
        }
        if (eobrun > 0) {
          refine_apply(br, coef, nz & se_mask & ~((1ull << k) - 1), p1, m1);
          eobrun--;
        }
#else
        int k = pp.ss;
        if (eobrun == 0) {
          while (k <= pp.se) {
            int32_t s;
            int rc = c.luts[ul.ac_lut].decode(br, &s);
            if (rc != JDT_OK) { *err_mcu = m; return rc; }
            int run = (s >> 4) & 0x0F;
            int size = s & 0x0F;
            int32_t val = 0;
            if (size == 0) {
              if (run != 15) {
                eobrun = 1 << run;
                if (run) eobrun += br.receive(run);
                break;
              }
              // ZRL: skip 16 zero-history coefficients
            } else {
              if (size != 1) { *err_mcu = m; return JDT_ERR_COEF_RANGE; }
              val = br.bit() ? p1 : m1;
            }
            while (k <= pp.se) {
              if (coef[k] != 0) {
                if (br.bit() && (coef[k] & p1) == 0)
                  coef[k] = static_cast<int16_t>(coef[k] +
                                                 (coef[k] >= 0 ? p1 : m1));
              } else {
                if (run == 0) break;
                run--;
              }
              k++;
            }
            if (val != 0 && k <= pp.se) coef[k] = static_cast<int16_t>(val);
            k++;
          }
        }
        if (eobrun > 0) {
          while (k <= pp.se) {
            if (coef[k] != 0) {
              if (br.bit() && (coef[k] & p1) == 0)
                coef[k] = static_cast<int16_t>(coef[k] +
                                               (coef[k] >= 0 ? p1 : m1));
            }
            k++;
          }
          eobrun--;
        }
#endif
      }
      if (br.overran()) { *err_mcu = m; return JDT_ERR_TRUNCATED; }
    }
  }
  return JDT_OK;
}

template <typename SegFn>
int32_t run_segments(const ScanContext& c, int32_t n_threads, int64_t* err_out,
                     SegFn seg_fn) {
  int64_t n = c.n_segs;
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  int workers = static_cast<int>(std::min<int64_t>(n_threads, n));
  if (workers <= 1) {
    for (int64_t s = 0; s < n; s++) {
      int64_t err_mcu = -1;
      int rc = seg_fn(c, s, &err_mcu);
      if (rc != JDT_OK) {
        err_out[0] = s;
        err_out[1] = err_mcu;
        return rc;
      }
    }
    return JDT_OK;
  }
  std::atomic<int64_t> next(0);
  std::atomic<int32_t> status(JDT_OK);
  std::atomic<int64_t> err_seg(-1), err_mcu_a(-1);
  auto worker = [&]() {
    for (;;) {
      int64_t s = next.fetch_add(1);
      if (s >= n || status.load(std::memory_order_relaxed) != JDT_OK) return;
      int64_t err_mcu = -1;
      int rc = seg_fn(c, s, &err_mcu);
      if (rc != JDT_OK) {
        int32_t expected = JDT_OK;
        if (status.compare_exchange_strong(expected, rc)) {
          err_seg.store(s);
          err_mcu_a.store(err_mcu);
        }
        return;
      }
    }
  };
  pool_run(workers, [&](int) { worker(); });
  err_out[0] = err_seg.load();
  err_out[1] = err_mcu_a.load();
  return status.load();
}

// ---------------------------------------------------------------------------
// Register-resident multi-stream decode (the DRI fast path).
// Key ideas (Huff0-style multi-stream, adapted to JPEG restart segments):
//   * each segment's entropy bytes are unstuffed ONCE into a padded
//     scratch buffer, so the hot loop has no 0xFF handling at all;
//   * the bit reader is STATELESS: a window is derived from (base, bitpos)
//     by one clamped 8-byte load + bswap + shift, always >= 57 valid bits,
//     so there is no fill() and no nbits bookkeeping;
//   * per-stream hot state is just {bitpos, coef index, du, table ptr} —
//     small enough that K streams live in registers and their dependent
//     LUT-load chains overlap in the out-of-order window.
// ---------------------------------------------------------------------------
constexpr int kRegMaxUnits = 10;  // JPEG A.2.4: sum of hsf*vsf per scan <= 10

// Zero pad past the unstuffed segment so the window loader needs no bounds
// clamp: one DU between truncation checks runs <= 64 probes x <= 32 bits
// = 256 bytes of possible overrun, +8 for the 64-bit load, rounded up.
constexpr int kRegPad = 272;

struct RegStream {
  std::vector<uint8_t> buf;  // unstuffed bytes + kRegPad zero-pad
  int64_t len = 0;           // unstuffed length (bits = 8*len)
  // (A raw-window variant that decoded straight off the stuffed stream —
  // no unstuff copy, one guard compare on the probe chain — was built and
  // retired in round 4: quiet-machine interleaved A/B measured it a WASH
  // at 4 threads and consistently 3-5% slower at 1 thread, while its
  // guard compare taxed the buffered path too. The unstuff copy doubles
  // as L1 cache staging; see PERF.md.)
  int64_t seg = -1, mcu = 0, mcu_hi = 0;
  int32_t unit = 0, scomp = 0;
  int32_t preds[4];
  const HuffLut* dc = nullptr;
  const HuffLut* ac = nullptr;
  int16_t* du = nullptr;
  // Incrementally-maintained block coordinates per unit-in-MCU (avoids the
  // 64-bit div/mod of `base % wrap` on every data unit): for unit u at MCU
  // m, ubx/uby equal ((m*h+k) % wrap, (m*h+k)/wrap*v + j).
  int32_t ubx[kRegMaxUnits];
  int32_t uby[kRegMaxUnits];
  int16_t scratch_du[64];
};

// One clamped window load: >= 57 valid bits at bitpos (zero bits past the
// unstuffed end — the pad provides them, the clamp bounds deep overruns).
// No clamp on the critical bitpos->window->probe chain: between du_done
// truncation checks (bp <= 8*len+7) a DU runs at most 64 probes of <= 32
// bits each, so bitpos overruns the unstuffed end by < 2048 bits — the
// kRegPad zero bytes cover every reachable read.
__attribute__((always_inline)) static inline uint64_t reg_win(
    const uint8_t* b, int64_t bitpos) {
  uint64_t v;
  std::memcpy(&v, b + (bitpos >> 3), 8);
  return __builtin_bswap64(v) << (bitpos & 7);
}

// Unstuff [lo, hi) into `buf` (segment bounds exclude markers, so every
// 0xFF inside is followed by a stuffed 0x00 — guaranteed by the prescan).
static void reg_unstuff(const uint8_t* lo, const uint8_t* hi,
                        std::vector<uint8_t>& bufv, int64_t& out_len) {
  size_t n = static_cast<size_t>(hi - lo);
  bufv.resize(n + kRegPad);
  uint8_t* out = bufv.data();
  size_t w = 0;
  const uint8_t* p = lo;
  while (p < hi) {
    const uint8_t* ff = static_cast<const uint8_t*>(
        std::memchr(p, 0xFF, static_cast<size_t>(hi - p)));
    if (!ff) {
      std::memcpy(out + w, p, static_cast<size_t>(hi - p));
      w += static_cast<size_t>(hi - p);
      break;
    }
    size_t span = static_cast<size_t>(ff - p) + 1;  // include the 0xFF
    std::memcpy(out + w, p, span);
    w += span;
    p = ff + 1;
    if (p < hi && *p == 0x00) p++;  // skip the stuffed zero
  }
  std::memset(out + w, 0, kRegPad);
  out_len = static_cast<int64_t>(w);
}

// Index-driven unstuff: the prescan already located every stuffed 0xFF, so
// the per-segment memchr re-scan (a second full read of the stream) is
// replaced by straight span copies between the recorded positions.
static void reg_unstuff_indexed(const uint8_t* data, const int64_t* stuff,
                                int64_t n_stuff, int64_t lo, int64_t hi,
                                std::vector<uint8_t>& bufv,
                                int64_t& out_len) {
  size_t n = static_cast<size_t>(hi - lo);
  bufv.resize(n + kRegPad);
  uint8_t* out = bufv.data();
  const int64_t* f = std::lower_bound(stuff, stuff + n_stuff, lo);
  const int64_t* fe = stuff + n_stuff;
  size_t w = 0;
  int64_t p = lo;
  for (; f < fe && *f < hi; ++f) {
    size_t span = static_cast<size_t>(*f - p) + 1;  // include the 0xFF
    std::memcpy(out + w, data + p, span);
    w += span;
    p = *f + 2;  // skip the stuffed 0x00
  }
  if (p < hi) {
    std::memcpy(out + w, data + p, static_cast<size_t>(hi - p));
    w += static_cast<size_t>(hi - p);
  }
  std::memset(out + w, 0, kRegPad);
  out_len = static_cast<int64_t>(w);
}

// Point S.du/dc/ac/scomp at the current (mcu, unit) using the
// incrementally-maintained coordinates.
static inline void reg_set_du(const ScanContext& c, RegStream& S) {
  const UnitLayout& ul = c.units[S.unit];
  int32_t bx = S.ubx[S.unit];
  int32_t by = S.uby[S.unit];
  S.du = (by < ul.plane_bh && bx < ul.plane_bw)
             ? c.planes[ul.plane] + ((int64_t)by * ul.plane_bw + bx) * 64
             : S.scratch_du;
  std::memset(S.du, 0, 64 * sizeof(int16_t));
  S.dc = &c.luts[ul.dc_lut];
  S.ac = &c.luts[ul.ac_lut];
  S.scomp = ul.scomp;
}

__attribute__((noinline)) static bool reg_advance(const ScanContext& c,
                                                  RegStream& S) {
  S.unit++;
  if (S.unit >= (int32_t)c.units.size()) {
    S.unit = 0;
    S.mcu++;
    if (S.mcu >= S.mcu_hi) return false;
    // One MCU step: each unit's column advances by its h; each wrap of the
    // block-column width drops it one block row (v). The loop runs >1 time
    // only when wrap < h (plane narrower than one MCU).
    for (int32_t u = 0; u < (int32_t)c.units.size(); u++) {
      const UnitLayout& ul = c.units[u];
      S.ubx[u] += ul.h;
      while (S.ubx[u] >= ul.wrap) {
        S.ubx[u] -= ul.wrap;
        S.uby[u] += ul.v;
      }
    }
  }
  reg_set_du(c, S);
  return true;
}

static bool reg_init_segment(const ScanContext& c, RegStream& S,
                             int64_t seg) {
  S.seg = seg;
  int64_t lo = c.seg_bounds[2 * seg];
  int64_t hi = c.seg_bounds[2 * seg + 1];
  if (c.stuff != nullptr && c.n_stuff >= 0) {
    reg_unstuff_indexed(c.data, c.stuff, c.n_stuff, lo, hi, S.buf, S.len);
  } else {
    reg_unstuff(c.data + lo, c.data + hi, S.buf, S.len);
  }
  S.preds[0] = S.preds[1] = S.preds[2] = S.preds[3] = 0;
  int64_t mcu_lo = c.ri ? seg * c.ri : 0;
  S.mcu_hi = c.ri ? std::min<int64_t>(mcu_lo + c.ri, c.total_mcus)
                  : c.total_mcus;
  if (mcu_lo >= S.mcu_hi) return false;
  S.mcu = mcu_lo;
  S.unit = 0;
  for (int32_t u = 0; u < (int32_t)c.units.size(); u++) {
    const UnitLayout& ul = c.units[u];
    int64_t base = mcu_lo * ul.h + ul.k;
    S.ubx[u] = (int32_t)(base % ul.wrap);
    S.uby[u] = (int32_t)((base / ul.wrap) * ul.v + ul.j);
  }
  reg_set_du(c, S);
  return true;
}

// One hot step for stream k. Hot state (bitpos bp, coef index ci, du
// pointer, AC pair-table pointer) passed by reference so it stays in
// registers across rounds. Returns 0 = alive, 1 = segment done, -rc error.
__attribute__((always_inline)) static inline int reg_step(
    const ScanContext& c, RegStream& S, const uint8_t*& base, int64_t len,
    int64_t& bp, int32_t& ci, int16_t*& du, const uint64_t*& vac) {
  uint64_t w = reg_win(base, bp);
  if (ci == 0) {  // DC: code (<=16) + magnitude (<=15) fit one window
    uint32_t idx = static_cast<uint32_t>(w >> 48);
    uint32_t e = S.dc->lut12[idx >> 4];
    if (e == 0) {
      e = S.dc->lut16[idx];
      if ((e >> 8) == 0) return -JDT_ERR_BAD_CODE;
    }
    int s = e & 0xFF;
    bp += e >> 8;
    if (s > 15) return -JDT_ERR_COEF_RANGE;
    if (s) {
      int32_t v = static_cast<int32_t>((w << (e >> 8)) >> (64 - s));
      bp += s;
      S.preds[S.scomp] += extend(v, s);
    }
    du[0] = static_cast<int16_t>(S.preds[S.scomp]);
    ci = 1;
    return 0;
  }
  uint64_t en = vac[static_cast<uint32_t>(w >> JDT_PAIR_SHIFT)];
  int off2 = (en >> 36) & 63;
  if (((((en >> 53) & 3) != 0) | (ci + off2 > 63)) == 0) {
    du[ci + ((en >> 32) & 15)] = static_cast<int16_t>(en & 0xFFFF);
    du[ci + off2] = static_cast<int16_t>((en >> 16) & 0xFFFF);
    int64_t b1 = (en >> 46) & 63;
    ci += off2 + 1;
    if (ci < 64) {
      // Double-pump: a value-resolved entry consumes <= PAIR_BITS bits,
      // so the shifted window still holds >= 64 - PAIR_BITS valid bits —
      // probe it again in the SAME round, amortizing reg_win and the
      // per-round stream overhead (measured +6% on the 4K q85 DRI
      // workload, 1T paired A/B; a third pump measured a wash).
      uint64_t w2 = w << b1;
      uint64_t en2 = vac[static_cast<uint32_t>(w2 >> JDT_PAIR_SHIFT)];
      int off2b = (en2 >> 36) & 63;
      if (((((en2 >> 53) & 3) != 0) | (ci + off2b > 63)) == 0) {
        du[ci + ((en2 >> 32) & 15)] = static_cast<int16_t>(en2 & 0xFFFF);
        du[ci + off2b] = static_cast<int16_t>((en2 >> 16) & 0xFFFF);
        bp += b1 + ((en2 >> 46) & 63);
        ci += off2b + 1;
        if (ci < 64) return 0;
        goto du_done;
      }
      bp += b1;
      return 0;
    }
    bp += b1;
    goto du_done;
  }
  {
    int kind = static_cast<int>(en >> 52) & 7;
    switch (kind) {
      case HuffLut::K2_PAIR:
      case HuffLut::K2_COEF: {
        ci += (en >> 32) & 15;
        if (ci > 63) return -JDT_ERR_COEF_RANGE;
        du[ci] = static_cast<int16_t>(en & 0xFFFF);
        bp += (en >> 42) & 15;
        ci++;
        if (ci < 64) return 0;
        goto du_done;
      }
      case HuffLut::K2_COEF_EOB: {
        ci += (en >> 32) & 15;
        if (ci > 63) return -JDT_ERR_COEF_RANGE;
        du[ci] = static_cast<int16_t>(en & 0xFFFF);
        bp += ci == 63 ? (en >> 42) & 15 : (en >> 46) & 63;
        goto du_done;
      }
      case HuffLut::K2_EOB:
        bp += (en >> 46) & 63;
        goto du_done;
      case HuffLut::K2_ZRL:
        bp += (en >> 46) & 63;
        ci += 16;
        if (ci < 64) return 0;
        goto du_done;
      default: {  // K2_SLOW: long code or long extend — one window is enough
        uint32_t idx = static_cast<uint32_t>(w >> 48);
        uint32_t e = S.ac->lut12[idx >> 4];
        if (e == 0) {
          e = S.ac->lut16[idx];
          if ((e >> 8) == 0) return -JDT_ERR_BAD_CODE;
        }
        int sym = e & 0xFF;
        ci += sym >> 4;
        if (sym == 0x00) { bp += e >> 8; goto du_done; }
        if (sym == 0xF0) {
          bp += e >> 8;
          ci += 1;
          if (ci >= 64) goto du_done;
          return 0;
        }
        if (ci > 63) return -JDT_ERR_COEF_RANGE;
        int size = sym & 0x0F;
        // A corrupt DHT can assign a 13-16 bit code to an RRRR/0 symbol
        // (size==0): guard the shift like BitReader's slow path does, else
        // `>> (64 - size)` is a shift by 64 (UB). extend(v,0)==0.
        int32_t v = size ? static_cast<int32_t>((w << (e >> 8)) >> (64 - size)) : 0;
        bp += (e >> 8) + size;
        du[ci] = static_cast<int16_t>(extend(v, size));
        ci++;
        if (ci >= 64) goto du_done;
        return 0;
      }
    }
  }
du_done:
  // Truncation rule: consuming past the unstuffed end by more than the 7
  // possible 1-fill alignment bits (same rule as BitReader.overran).
  if (bp > 8 * len + 7) return -JDT_ERR_TRUNCATED;
  if (!reg_advance(c, S)) return 1;
  ci = 0;
  du = S.du;
  vac = S.ac->vlut2;
  return 0;
}

template <int K>
int32_t reg_run(const ScanContext& c, int32_t n_threads,
                int64_t* err_out) {
  int64_t n = c.n_segs;
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  int workers = static_cast<int>(
      std::min<int64_t>(n_threads, (n + K - 1) / K));
  std::atomic<int64_t> next(0);
  std::atomic<int32_t> status(JDT_OK);
  std::atomic<int64_t> err_seg(-1), err_mcu_a(-1);
  auto fail = [&](int32_t rc, int64_t seg, int64_t mcu) {
    int32_t expected = JDT_OK;
    if (status.compare_exchange_strong(expected, rc)) {
      err_seg.store(seg);
      err_mcu_a.store(mcu);
    }
  };
  auto worker = [&]() {
    RegStream st[K];
    const uint8_t* base[K];
    int64_t len[K];
    int64_t bp[K];
    int32_t ci[K];
    int16_t* du[K];
    const uint64_t* vac[K];
    uint32_t livemask = 0;
    auto grab = [&](int k) -> bool {
      for (;;) {
        int64_t s = next.fetch_add(1);
        if (s >= n || status.load(std::memory_order_relaxed) != JDT_OK)
          return false;
        if (reg_init_segment(c, st[k], s)) {
          base[k] = st[k].buf.data();
          len[k] = st[k].len;
          bp[k] = 0;
          ci[k] = 0;
          du[k] = st[k].du;
          vac[k] = st[k].ac->vlut2;
          return true;
        }
      }
    };
    for (int k = 0; k < K; k++)
      if (grab(k)) livemask |= 1u << k;
    int rounds = 0;
    while (livemask) {
#pragma GCC unroll 8
      for (int k = 0; k < K; k++) {
        if (!(livemask & (1u << k))) continue;
        int r = reg_step(c, st[k], base[k], len[k], bp[k], ci[k], du[k],
                         vac[k]);
        if (__builtin_expect(r != 0, 0)) {
          if (r < 0) {
            fail(static_cast<int32_t>(-r), st[k].seg, st[k].mcu);
            return;
          }
          if (!grab(k)) livemask &= ~(1u << k);
        }
      }
      if (((++rounds) & 1023) == 0 &&
          status.load(std::memory_order_relaxed) != JDT_OK)
        return;
    }
  };
  if (workers <= 1) {
    worker();
  } else {
    pool_run(workers, [&](int) { worker(); });
  }
  err_out[0] = err_seg.load();
  err_out[1] = err_mcu_a.load();
  return status.load();
}

ScanContext build_context(const uint8_t* data, const int64_t* seg_bounds,
                          int64_t n_segs, int64_t total_mcus, int64_t ri,
                          const int32_t* unit_params, int32_t n_units,
                          const uint16_t* const* lut12s,
                          const uint16_t* const* lut16s,
                          const int32_t* const* vluts,
                          const int32_t* const* pvluts,
                          const uint64_t* const* vlut2s, int32_t n_luts,
                          int16_t** planes) {
  ScanContext c;
  c.data = data;
  c.seg_bounds = seg_bounds;
  c.n_segs = n_segs;
  c.total_mcus = total_mcus;
  c.ri = ri;
  c.units.resize(n_units);
  for (int32_t u = 0; u < n_units; u++) {
    const int32_t* q = unit_params + u * 11;
    c.units[u] = UnitLayout{q[0], q[1], q[2], q[3], q[4], q[5],
                            q[6], q[7], q[8], q[9], q[10]};
  }
  c.luts.resize(n_luts);
  for (int32_t t = 0; t < n_luts; t++)
    c.luts[t] = HuffLut{lut12s[t], lut16s[t], vluts[t],
                        pvluts ? pvluts[t] : nullptr,
                        vlut2s ? vlut2s[t] : nullptr};
  c.planes = planes;
  return c;
}

// ---------------------------------------------------------------------------
// Speculative self-synchronizing parallel decode (no restart markers).
//
// For sequential scans WITHOUT restart intervals there is no built-in
// parallel seam; this implements the overlap-synchronization technique from
// the GPU JPEG-decoding literature (Weissenberger & Schmidt,
// arXiv:2111.09219): the entropy span splits into K byte chunks; worker k
// starts decoding at its chunk boundary with UNKNOWN bit alignment (and,
// for interleaved scans, UNKNOWN unit-within-MCU phase) and records every
// data-unit start. Huffman streams self-synchronize: within a few data
// units a misaligned decode converges onto the true boundary lattice, so
// worker k-1 (which overruns its chunk end by a fixed window) and worker k
// share a common boundary — everything worker k decoded after that point is
// provably identical to the true decode.
//
// INTERLEAVED scans (the common camera/web JPEG shape) are handled by
// folding the table phase into the synchronization key: each recorded DU
// carries key = bitpos * P + phase, where P = units-per-MCU and phase is
// the unit index within the MCU the worker ASSUMED for that DU (choosing
// which DC/AC tables it decoded with). Keys are strictly monotone (a DU
// consumes >= 3 bits > (P-1)/P), so the merge-join over sorted key lists
// still works; a key match proves both the bit position AND the table
// schedule agree, after which both chains consume identical bits with
// identical tables — the suffix is deterministic and exactly the true
// decode. Workers explore the (bit-shift x phase-rotation) hypothesis
// space on decode errors; wrong-phase chains that decode "successfully"
// never key-match the predecessor's absolute chain and are discarded.
//
// DC values are stored as DIFFS during speculation (alignment-independent)
// and resolved by per-scan-component prefix sums after stitching. Any
// anomaly — no sync, decode error in the exact chain, wrong total, phase
// lattice mismatch — falls back to the serial path.
// ---------------------------------------------------------------------------

// Non-temporal 128-byte DU copy for the speculative STAGING traffic.
// Staged DUs are consumed only after every worker finishes (the stitch
// reads keys, the scatter reads dus), so caching ~24 MB of staging lines
// is pure pollution of the L2 the window loads live in — and a regular
// store additionally pays a write-allocate READ of each destination line
// first. Streaming stores skip both; on the bandwidth-poor serving host
// that traffic is the measured DRI-vs-no-DRI gap (PERF.md, host findings).
// The destination stride is 128 B, so alignment is uniform per buffer:
// one check, then full-cache-line WC writes. Callers that need the data
// visible to OTHER threads must fence once after their loop (NT stores
// are weakly ordered; pool_run's join alone is not an architected flush).
static inline void du_store_nt(int16_t* dst, const int16_t* src) {
#if defined(__SSE2__)
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const __m128i* s = reinterpret_cast<const __m128i*>(src);
    __m128i* d = reinterpret_cast<__m128i*>(dst);
    _mm_stream_si128(d + 0, _mm_loadu_si128(s + 0));
    _mm_stream_si128(d + 1, _mm_loadu_si128(s + 1));
    _mm_stream_si128(d + 2, _mm_loadu_si128(s + 2));
    _mm_stream_si128(d + 3, _mm_loadu_si128(s + 3));
    _mm_stream_si128(d + 4, _mm_loadu_si128(s + 4));
    _mm_stream_si128(d + 5, _mm_loadu_si128(s + 5));
    _mm_stream_si128(d + 6, _mm_loadu_si128(s + 6));
    _mm_stream_si128(d + 7, _mm_loadu_si128(s + 7));
    return;
  }
#endif
  std::memcpy(dst, src, 64 * sizeof(int16_t));
}

static inline void spec_store_fence() {
#if defined(__SSE2__)
  _mm_sfence();
#endif
}

struct SpecChunk {
  // Backing storage is cursor-addressed: `n` DUs are valid, the vectors
  // are capacity (sized >= n, possibly larger from arena reuse). The hot
  // multistream loop writes through raw pointers + one cursor increment —
  // three push_backs plus a 128-byte vector::insert per DU cost ~9 header
  // read-modify-writes and a libc memmove dispatch, measurable at this
  // loop's ~0.2 us/DU budget.
  std::vector<int16_t> dus;   // 64 per DU, du[0] = DC DIFF (fits int16:
                              // a single EXTEND is <= 15 bits)
  std::vector<int32_t> dcs;   // compact copy of each DU's DC diff — the
                              // prefix pass reads these 4B/DU instead of
                              // touching every 128B staging cache line
  std::vector<int64_t> keys;  // global unstuffed bitpos * P + phase per DU
  int64_t n = 0;              // valid DU count
  bool error = false;
};

constexpr int64_t kOverrunBits = 24 * 1024;  // overlap window per boundary

// Recycled staging memory for the speculative engine. The per-chunk DU
// staging (~2 MB/chunk) and unstuffed-chunk buffers (~0.4 MB/chunk) exceed
// glibc's mmap threshold, so allocating them fresh each call means the
// kernel maps, zero-fills, and unmaps ~25 MB per image: measured 6,506
// minor faults per 4K no-DRI decode vs 12 on the DRI path, costing several
// ms of fault/zeroing time inside the hot workers. The arena keeps the
// vectors alive across calls (clear() preserves capacity), dropping the
// steady-state fault count to ~0. One arena, mutex-guarded: a concurrent
// second caller falls back to fresh local vectors (correct, just cold).
struct SpecArena {
  std::vector<SpecChunk> chunks;
  std::vector<std::vector<uint8_t>> bufs;  // per-chunk unstuffed bytes
  bool in_use = false;
};
static std::mutex g_spec_arena_mu;
static SpecArena g_spec_arena;

struct SpecArenaLease {
  SpecArena* a = nullptr;
  SpecArena local;  // fallback when the shared arena is busy
  SpecArenaLease() {
    std::lock_guard<std::mutex> lk(g_spec_arena_mu);
    if (!g_spec_arena.in_use) {
      g_spec_arena.in_use = true;
      a = &g_spec_arena;
    }
  }
  ~SpecArenaLease() {
    if (a == &g_spec_arena) {
      std::lock_guard<std::mutex> lk(g_spec_arena_mu);
      g_spec_arena.in_use = false;
    }
  }
  SpecArena& get() { return a ? *a : local; }
};

// When `planes` is non-null the worker is the EXACT chunk-0 chain: its
// alignment, phase, and DC predictors are ground truth from the first bit,
// so it decodes STRAIGHT into the coefficient planes (skipping its share
// of staging write+read+scatter). It still records keys (for the stitch
// with chunk 1) and compact DC diffs (for the successor's predictor base).
// Overlap DUs past the eventual sync point hold correct values, so chunk
// 1's scatter merely rewrites identical data.
void speculative_worker(const uint8_t* data, int64_t scan_start,
                        int64_t chunk_begin, int64_t scan_end,
                        int64_t global_unstuffed_base,  // bits before chunk
                        int64_t stop_after_bits,        // global bit limit
                        int64_t max_dus, int64_t reserve_hint,
                        const std::vector<UnitLayout>* units,
                        const std::vector<HuffLut>* luts, bool exact,
                        int16_t** planes, SpecChunk* out) {
  auto t0 = std::chrono::steady_clock::now();
  const int P = static_cast<int>(units->size());
  // A chunk must not begin on the 0x00 of a stuffed FF00 pair. The base
  // correction: chunk_bits counted that pair's 0x00 as "stuffed before",
  // but the preceding 0xFF is content before the bumped cursor, so the
  // true unstuffed base is one byte later.
  if (chunk_begin > scan_start && data[chunk_begin] == 0x00 &&
      data[chunk_begin - 1] == 0xFF) {
    chunk_begin++;
    global_unstuffed_base += 8;
  }
  BitReader br;
  br.init(data + chunk_begin, data + scan_end);
  int16_t stage[64];
  int16_t scratch[64];
  const bool direct = planes != nullptr;
  // Cursor-addressed staging (same contract as the multistream engine):
  // backing sized up front, raw writes, out->n set at the end.
  int64_t n = 0;
  int64_t cap0 = reserve_hint + 4096;
  if (static_cast<int64_t>(out->keys.size()) < cap0) {
    out->keys.resize(cap0);
    out->dcs.resize(cap0);
  }
  if (!direct && out->dus.size() < out->keys.size() * 64)
    out->dus.resize(out->keys.size() * 64);
  int64_t cap = static_cast<int64_t>(out->keys.size());
  int64_t retries = 0;
  constexpr int64_t kMaxRetries = 1 << 16;
  int phase = 0;  // unit-within-MCU hypothesis for the NEXT data unit
  int rot = 0;    // phase rotations already tried at the current bit
  int32_t preds[4] = {0, 0, 0, 0};  // live predictors (direct mode only)
  while (n < max_dus) {
    int64_t pos = global_unstuffed_base + br.unstuffed_pos();
    if (pos >= stop_after_bits) break;
    BitReader at_start = br;  // snapshot for resync on failure
    const UnitLayout& ul = (*units)[phase];
    int16_t* du = stage;
    int32_t dc_diff = 0;
    int32_t* pred = &dc_diff;  // DC stored as diff: fresh predictor per DU
    if (direct) {
      int64_t idx = n;
      int64_t base = (idx / P) * ul.h + ul.k;
      int64_t bx = base % ul.wrap;
      int64_t by = (base / ul.wrap) * ul.v + ul.j;
      du = (by < ul.plane_bh && bx < ul.plane_bw)
               ? planes[ul.plane] + (by * ul.plane_bw + bx) * 64
               : scratch;
      int32_t before = preds[ul.scomp];
      pred = &preds[ul.scomp];
      dc_diff = before;  // so dc_diff below can recover the diff
    }
    int rc = decode_du_sequential(br, (*luts)[ul.dc_lut], (*luts)[ul.ac_lut],
                                  pred, du);
    if (rc != JDT_OK) {
      // Misaligned/mis-phased speculation hit an invalid prefix or an
      // overlong block: explore the hypothesis space — first rotate the
      // phase at this bit (P-1 more options), then shift the start by ONE
      // BIT and start the rotation over. This is what makes
      // self-synchronization converge (incomplete JPEG code tables reject
      // most wrong hypotheses quickly). The EXACT worker (chunk 0, true
      // alignment and phase) must NOT resync: its errors are real stream
      // corruption and force the serial fallback's error report.
      if (exact || ++retries > kMaxRetries) {
        out->error = true;
        break;
      }
      // Past the real (unstuffed) end the reader fabricates zero bytes —
      // no valid DU can start there, so retrying hypotheses against the
      // padding only burns time (the last chunk would otherwise spin
      // through the full retry budget after the final real data unit).
      if (at_start.overran()) {
        out->error = true;
        break;
      }
      br = at_start;
      if (++rot < P) {
        phase = (phase + 1) % P;
      } else {
        rot = 0;
        phase = (phase + 1) % P;  // net effect: back to the pre-rotation
                                  // phase, at the next bit offset
        br.fill();
        br.consume(1);
      }
      continue;
    }
    rot = 0;
    if (n == cap) {
      cap = cap * 2 + 1024;
      out->keys.resize(cap);
      out->dcs.resize(cap);
      if (!direct) out->dus.resize(cap * 64);
    }
    out->keys[n] = pos * P + phase;
    if (direct) {
      out->dcs[n] = *pred - dc_diff;  // store the DIFF, not the value
    } else {
      out->dcs[n] = du[0];
      std::memcpy(out->dus.data() + n * 64, du, 64 * sizeof(int16_t));
    }
    n++;
    phase = (phase + 1) % P;
    if (br.overran()) break;  // consuming fabricated padding: stream over
  }
  out->n = n;
  if (std::getenv("JDT_DEBUG")) {
    auto t1 = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[spec] worker base=%lld: %.2fms %lld dus\n",
                 (long long)global_unstuffed_base,
                 std::chrono::duration<double, std::milli>(t1 - t0).count(),
                 (long long)n);
  }
}


// ---------------------------------------------------------------------------
// Multi-stream speculative engine. The BitReader speculative_worker above is
// the semantic reference, but it decodes one chunk per thread with a single
// dependent probe chain (~3x slower per DU than the register-resident
// kernel). This engine splits the span into (workers x kSpecK) chunks and
// has each worker interleave kSpecK chunk streams through the same
// window/LUT arms as reg_step — the cross-stream ILP that makes the DRI
// path fast, applied to speculation. Chunks are unstuffed up front (via the
// prescan's stuff index when available), so windows are straight loads and
// the sync key position is simply base_bits + bit cursor.
// KEEP THE DECODE ARMS IN SYNC WITH reg_step — both must stay bitwise
// equivalent to decode_du_sequential.
// ---------------------------------------------------------------------------

constexpr int kSpecK = 4;
constexpr int64_t kMaxSpecRetries = 1 << 16;

struct SpecStream {
  const uint8_t* buf = nullptr;  // unstuffed chunk bytes + kRegPad zeros
                                 // (storage owned by the SpecArena)
  int64_t len = 0;               // unstuffed length (real bytes)
  int64_t bp = 0;            // bit cursor in buf
  int64_t bp_du = 0;         // bp at the current DU's start (resync point)
  int32_t ci = 0;
  int64_t base_bits = 0;     // global unstuffed bits before this chunk
  int64_t stop_bits = 0;     // stop decoding once base_bits + bp >= this
  int64_t max_dus = 0;
  int P = 1;
  int phase = 0;             // unit-within-MCU hypothesis for current DU
  int rot = 0;               // phase rotations tried at the current bit
  int64_t retries = 0;
  const std::vector<UnitLayout>* units = nullptr;
  const std::vector<HuffLut>* luts = nullptr;
  const HuffLut* dc = nullptr;
  const HuffLut* ac = nullptr;
  const uint64_t* vac = nullptr;
  int16_t* du = nullptr;
  int32_t* pred = nullptr;
  int32_t pred_du0 = 0;      // direct: predictor value at DU start
  bool direct = false;       // chunk 0: decode straight into the planes
  bool exact = false;        // chunk 0: decode errors are real corruption
  int16_t stage[64];
  int16_t scratch[64];
  int32_t preds[4] = {0, 0, 0, 0};
  int32_t dc_diff = 0;
  int16_t** planes = nullptr;
  SpecChunk* out = nullptr;
  // Raw staging cursors mirroring out->{keys,dcs,dus} (each chunk is owned
  // by exactly one stream; S.n is written back to out->n as it goes via
  // spec_grow / the final flush in du_done's callers).
  int64_t n = 0;
  int64_t cap = 0;
  int64_t* keys_w = nullptr;
  int32_t* dcs_w = nullptr;
  int16_t* dus_w = nullptr;
};

// Rare: staging capacity exhausted (a desynced stream inventing tiny fake
// DUs can exceed the expected-count estimate). Amortized doubling.
__attribute__((noinline)) static void spec_grow(SpecStream& S) {
  int64_t nc = S.cap * 2 + 1024;
  SpecChunk& ch = *S.out;
  ch.keys.resize(nc);
  ch.dcs.resize(nc);
  if (!S.direct) ch.dus.resize(nc * 64);
  S.cap = nc;
  S.keys_w = ch.keys.data();
  S.dcs_w = ch.dcs.data();
  S.dus_w = ch.dus.data();
}

static void spec_set_du(SpecStream& S) {
  const UnitLayout& ul = (*S.units)[S.phase];
  if (S.direct) {
    int64_t idx = S.n;
    int64_t base = (idx / S.P) * ul.h + ul.k;
    int64_t bx = base % ul.wrap;
    int64_t by = (base / ul.wrap) * ul.v + ul.j;
    S.du = (by < ul.plane_bh && bx < ul.plane_bw)
               ? S.planes[ul.plane] + (by * ul.plane_bw + bx) * 64
               : S.scratch;
    S.pred = &S.preds[ul.scomp];
    S.pred_du0 = *S.pred;
  } else {
    S.du = S.stage;
    S.dc_diff = 0;
    S.pred = &S.dc_diff;
  }
  std::memset(S.du, 0, 64 * sizeof(int16_t));
  S.dc = &(*S.luts)[ul.dc_lut];
  S.ac = &(*S.luts)[ul.ac_lut];
  S.vac = S.ac->vlut2;
}

// One hot step for a speculative stream. Hot state (bit cursor, coef
// index, du pointer, AC pair table) is passed by reference so it stays in
// registers across interleaved rounds, exactly like reg_step. Returns
// 0 = alive, 1 = stream finished (successfully or with out->error set).
// Decode arms mirror reg_step bitwise; DU completion/resync logic mirrors
// speculative_worker.
__attribute__((always_inline)) static inline int spec_step(
    SpecStream& S, const uint8_t* b, int64_t& bp, int32_t& ci,
    int16_t*& du, const uint64_t*& vac) {
  uint64_t w = reg_win(b, bp);
  if (ci == 0) {  // DC: code (<=16) + magnitude (<=15) fit one window
    uint32_t idx = static_cast<uint32_t>(w >> 48);
    uint32_t e = S.dc->lut12[idx >> 4];
    if (e == 0) {
      e = S.dc->lut16[idx];
      if ((e >> 8) == 0) goto spec_error;
    }
    {
      int sz = e & 0xFF;
      bp += e >> 8;
      if (sz > 15) goto spec_error;
      if (sz) {
        int32_t v = static_cast<int32_t>((w << (e >> 8)) >> (64 - sz));
        bp += sz;
        *S.pred += extend(v, sz);
      }
      du[0] = static_cast<int16_t>(*S.pred);
      ci = 1;
      return 0;
    }
  }
  {
    uint64_t en = vac[static_cast<uint32_t>(w >> JDT_PAIR_SHIFT)];
    int off2 = (en >> 36) & 63;
    if (((((en >> 53) & 3) != 0) | (ci + off2 > 63)) == 0) {
      du[ci + ((en >> 32) & 15)] = static_cast<int16_t>(en & 0xFFFF);
      du[ci + off2] = static_cast<int16_t>((en >> 16) & 0xFFFF);
      int64_t b1 = (en >> 46) & 63;
      ci += off2 + 1;
      if (ci < 64) {
        // Double-pump (mirrors reg_step bitwise — see its comment).
        uint64_t w2 = w << b1;
        uint64_t en2 = vac[static_cast<uint32_t>(w2 >> JDT_PAIR_SHIFT)];
        int off2b = (en2 >> 36) & 63;
        if (((((en2 >> 53) & 3) != 0) | (ci + off2b > 63)) == 0) {
          du[ci + ((en2 >> 32) & 15)] = static_cast<int16_t>(en2 & 0xFFFF);
          du[ci + off2b] = static_cast<int16_t>((en2 >> 16) & 0xFFFF);
          bp += b1 + ((en2 >> 46) & 63);
          ci += off2b + 1;
          if (ci < 64) return 0;
          goto du_done;
        }
        bp += b1;
        return 0;
      }
      bp += b1;
      goto du_done;
    }
    int kind = static_cast<int>(en >> 52) & 7;
    switch (kind) {
      case HuffLut::K2_PAIR:
      case HuffLut::K2_COEF: {
        ci += (en >> 32) & 15;
        if (ci > 63) goto spec_error;
        du[ci] = static_cast<int16_t>(en & 0xFFFF);
        bp += (en >> 42) & 15;
        ci++;
        if (ci < 64) return 0;
        goto du_done;
      }
      case HuffLut::K2_COEF_EOB: {
        ci += (en >> 32) & 15;
        if (ci > 63) goto spec_error;
        du[ci] = static_cast<int16_t>(en & 0xFFFF);
        bp += ci == 63 ? (en >> 42) & 15 : (en >> 46) & 63;
        goto du_done;
      }
      case HuffLut::K2_EOB:
        bp += (en >> 46) & 63;
        goto du_done;
      case HuffLut::K2_ZRL:
        bp += (en >> 46) & 63;
        ci += 16;
        if (ci < 64) return 0;
        goto du_done;
      default: {  // K2_SLOW: long code or long extend
        uint32_t idx = static_cast<uint32_t>(w >> 48);
        uint32_t e = S.ac->lut12[idx >> 4];
        if (e == 0) {
          e = S.ac->lut16[idx];
          if ((e >> 8) == 0) goto spec_error;
        }
        int sym = e & 0xFF;
        ci += sym >> 4;
        if (sym == 0x00) { bp += e >> 8; goto du_done; }
        if (sym == 0xF0) {
          bp += e >> 8;
          ci += 1;
          if (ci >= 64) goto du_done;
          return 0;
        }
        if (ci > 63) goto spec_error;
        int sz = sym & 0x0F;
        int32_t v =
            sz ? static_cast<int32_t>((w << (e >> 8)) >> (64 - sz)) : 0;
        bp += (e >> 8) + sz;
        du[ci] = static_cast<int16_t>(extend(v, sz));
        ci++;
        if (ci >= 64) goto du_done;
        return 0;
      }
    }
  }
du_done: {
  if (__builtin_expect(S.n == S.cap, 0)) spec_grow(S);
  int64_t pos = S.base_bits + S.bp_du;
  S.keys_w[S.n] = pos * S.P + S.phase;
  if (S.direct) {
    S.dcs_w[S.n] = *S.pred - S.pred_du0;  // store the DIFF
  } else {
    S.dcs_w[S.n] = du[0];
    du_store_nt(S.dus_w + S.n * 64, du);
  }
  S.n++;
  S.rot = 0;
  // Consumed fabricated zero padding: the stream is over (mirrors the
  // BitReader loop's push-then-break on overran()).
  if (bp > 8 * S.len + 7) return 1;
  S.phase = (S.phase + 1) % S.P;
  S.bp_du = bp;
  ci = 0;
  if (S.n >= S.max_dus) return 1;
  if (S.base_bits + bp >= S.stop_bits) return 1;
  spec_set_du(S);
  du = S.du;
  vac = S.ac->vlut2;
  return 0;
}
spec_error: {
  // Hypothesis exploration — same order as speculative_worker: rotate the
  // phase at this bit first, then shift the start by one bit.
  if (S.exact || ++S.retries > kMaxSpecRetries) {
    S.out->error = true;
    return 1;
  }
  if (S.bp_du > 8 * S.len + 7) {  // retrying against padding: stream over
    S.out->error = true;
    return 1;
  }
  if (++S.rot < S.P) {
    S.phase = (S.phase + 1) % S.P;
  } else {
    S.rot = 0;
    S.phase = (S.phase + 1) % S.P;
    S.bp_du += 1;
  }
  bp = S.bp_du;
  ci = 0;
  spec_set_du(S);
  du = S.du;
  vac = S.ac->vlut2;
  return 0;
}
}

// Returns JDT_OK and fills `planes` on success; JDT_ERR_BAD_ARG signals
// "could not synchronize — caller must run the serial path".
int decode_speculative(const uint8_t* data, int64_t scan_start,
                       int64_t scan_end, int64_t total_mcus,
                       const std::vector<UnitLayout>& units,
                       const std::vector<HuffLut>& luts, int16_t** planes,
                       int32_t n_threads, const int64_t* stuff,
                       int64_t n_stuff) {
  const int P = static_cast<int>(units.size());
  const int64_t total_dus = total_mcus * P;
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  int64_t span = scan_end - scan_start;
  // JDT_SPEC_MODE=bitreader forces the single-stream reference workers
  // (A/B hook; the multi-stream engine below is the default).
  const char* mode = std::getenv("JDT_SPEC_MODE");
  const bool multistream = !(mode && std::strcmp(mode, "bitreader") == 0);
  const int workers = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(1, span / (1 << 16))));
  // Multistream over-decomposes 4x beyond the stream count and lets the
  // worker loops GRAB chunks dynamically (same discipline as reg_run's
  // segment grab): on a shared VM, hypervisor steal against one vCPU
  // otherwise extends the whole statically-partitioned stage — measured
  // worker loops of 7.8 vs 17.1 ms for identical DU counts (r4). Finer
  // chunks cost one extra overlap window (~3 KB decode) per boundary.
  int k = multistream
              ? static_cast<int>(std::min<int64_t>(
                    static_cast<int64_t>(workers) * kSpecK * 4,
                    span / (1 << 16)))
              : std::min<int64_t>(n_threads, span / (1 << 16));
  if (k < 2) return JDT_ERR_BAD_ARG;

  // Global unstuffed bit offset of each chunk start: count FF00 pairs.
  // With the prescan's stuff index this is a binary search per boundary;
  // otherwise memchr hops 0xFF to 0xFF (libc SIMD scan).
  std::vector<int64_t> chunk_byte(k + 1), chunk_bits(k + 1);
  std::vector<int64_t> stuffed_before(k + 1, 0);
  for (int i = 0; i <= k; i++)
    chunk_byte[i] = scan_start + span * i / k;
  if (stuff != nullptr && n_stuff >= 0) {
    for (int i = 1; i <= k; i++)
      stuffed_before[i] =
          std::lower_bound(stuff, stuff + n_stuff, chunk_byte[i]) - stuff;
  } else {
    int64_t stuffed = 0;
    int next = 1;
    int64_t b = scan_start;
    while (b < scan_end && next <= k) {
      const void* hit = std::memchr(data + b, 0xFF, scan_end - b);
      int64_t ff = hit ? static_cast<const uint8_t*>(hit) - data : scan_end;
      while (next <= k && chunk_byte[next] <= ff) {
        stuffed_before[next] = stuffed;
        next++;
      }
      if (ff >= scan_end) break;
      if (ff + 1 < scan_end && data[ff + 1] == 0x00) stuffed++;
      b = ff + 1;
    }
    while (next <= k) stuffed_before[next++] = stuffed;
  }
  for (int i = 0; i <= k; i++)
    chunk_bits[i] = 8 * (chunk_byte[i] - scan_start - stuffed_before[i]);

  const bool dbg = std::getenv("JDT_DEBUG") != nullptr;
  auto t_setup = std::chrono::steady_clock::now();
  SpecArenaLease lease;
  SpecArena& arena = lease.get();
  if (static_cast<int>(arena.chunks.size()) < k) arena.chunks.resize(k);
  if (static_cast<int>(arena.bufs.size()) < k) arena.bufs.resize(k);
  for (int t = 0; t < k; t++) {
    // Cursor reset only — the backing vectors keep their SIZE (not just
    // capacity) so the per-call ensure-resize never re-zero-fills them.
    arena.chunks[t].n = 0;
    arena.chunks[t].error = false;
  }
  SpecChunk* chunks = arena.chunks.data();
  if (multistream) {
    // Chunks are pulled from a shared counter: each worker interleaves
    // kSpecK live streams (cross-stream ILP hides the probe chains, same
    // structure as reg_run: hot state in register-resident locals,
    // fixed-trip unrolled stream loop) and re-arms a slot with the next
    // unclaimed chunk when its stream ends, so a stalled vCPU sheds work
    // to the others instead of extending the stage.
    std::atomic<int> next_chunk(0);
    pool_run(workers, [&](int wslot) {
      auto tsetup0 = std::chrono::steady_clock::now();
      // Fixed-size slot array: SpecStream holds self-referential pointers
      // (pred into preds[], du into stage[]), so the storage must never
      // move after spec_set_du.
      SpecStream st[kSpecK];
      auto init_chunk = [&](SpecStream& S, int t) {
        S = SpecStream{};
        int64_t lo = chunk_byte[t];
        int64_t base = chunk_bits[t];
        // A chunk must not begin on the 0x00 of a stuffed FF00 pair (the
        // same correction as speculative_worker's).
        if (lo > scan_start && data[lo] == 0x00 && data[lo - 1] == 0xFF) {
          lo++;
          base += 8;
        }
        // Unstuffed buffer covering this chunk plus the overlap window
        // (stop extends kOverrunBits past the next boundary; the raw
        // margin below yields more unstuffed bits than that even at
        // pathological stuffing density).
        int64_t hi = (t + 1 < k)
                         ? std::min<int64_t>(
                               chunk_byte[t + 1] + kOverrunBits / 8 + 4096,
                               scan_end)
                         : scan_end;
        std::vector<uint8_t>& bufv = arena.bufs[t];  // recycled across calls
        if (stuff != nullptr && n_stuff >= 0)
          reg_unstuff_indexed(data, stuff, n_stuff, lo, hi, bufv, S.len);
        else
          reg_unstuff(data + lo, data + hi, bufv, S.len);
        S.buf = bufv.data();
        S.base_bits = base;
        S.stop_bits = (t + 1 < k) ? chunk_bits[t + 1] + kOverrunBits
                                  : std::numeric_limits<int64_t>::max();
        S.max_dus = total_dus + P * 16;
        S.P = P;
        S.units = &units;
        S.luts = &luts;
        S.direct = (t == 0) && planes != nullptr;
        S.exact = (t == 0);
        S.planes = planes;
        S.out = &chunks[t];
        // Cursor-addressed staging: size the backing once (arena reuse
        // keeps it across calls), write through raw pointers.
        SpecChunk& ch = *S.out;
        int64_t cap0 = total_dus / k + 4096;
        if (static_cast<int64_t>(ch.keys.size()) < cap0) {
          ch.keys.resize(cap0);
          ch.dcs.resize(cap0);
        }
        // dus must cover the full keys capacity (an arena slot may have
        // grown keys while serving as the direct chunk, which never
        // sizes dus).
        if (!S.direct && ch.dus.size() < ch.keys.size() * 64)
          ch.dus.resize(ch.keys.size() * 64);
        S.n = 0;
        S.cap = static_cast<int64_t>(ch.keys.size());
        S.keys_w = ch.keys.data();
        S.dcs_w = ch.dcs.data();
        S.dus_w = ch.dus.data();
        spec_set_du(S);
      };
      const uint8_t* base[kSpecK];
      int64_t bp[kSpecK];
      int32_t ci[kSpecK];
      int16_t* du[kSpecK];
      const uint64_t* vac[kSpecK];
      uint32_t livemask = 0;
      int64_t dus_done = 0;
      auto grab = [&](int i) -> bool {
        int t = next_chunk.fetch_add(1);
        if (t >= k) return false;
        init_chunk(st[i], t);
        base[i] = st[i].buf;
        bp[i] = 0;
        ci[i] = 0;
        du[i] = st[i].du;
        vac[i] = st[i].ac->vlut2;
        return true;
      };
      for (int i = 0; i < kSpecK; i++)
        if (grab(i)) livemask |= 1u << i;
      auto tw0 = std::chrono::steady_clock::now();
      int64_t retries = 0;
      while (livemask) {
#pragma GCC unroll 4
        for (int i = 0; i < kSpecK; i++) {
          if (!(livemask & (1u << i))) continue;
          if (__builtin_expect(
                  spec_step(st[i], base[i], bp[i], ci[i], du[i], vac[i]),
                  0)) {
            st[i].out->n = st[i].n;  // flush the staging cursor
            dus_done += st[i].n;
            retries += st[i].retries;
            if (!grab(i)) livemask &= ~(1u << i);
          }
        }
      }
      // Staged DUs were written with streaming stores; make them globally
      // visible before this worker reports done (stitch/scatter run on
      // other threads).
      spec_store_fence();
      // NOTE: no per-iteration instrumentation inside the loop above — even
      // a dbg-guarded clock call in the body forces the compiler to spill
      // the register-resident stream state across a potential call,
      // measured at ~2x on the whole loop.
      if (dbg) {
        auto tw1 = std::chrono::steady_clock::now();
        auto ms = [&](auto a, auto b) {
          return std::chrono::duration<double, std::milli>(b - a).count();
        };
        std::fprintf(stderr,
                     "[spec] mworker %d: setup=%.2fms loop=%.2fms %lld dus "
                     "%lld retries\n",
                     wslot, ms(tsetup0, tw0), ms(tw0, tw1),
                     (long long)dus_done, (long long)retries);
      }
    });
  } else {
    pool_run(k, [&](int t) {
      int64_t stop = (t + 1 < k)
                         ? chunk_bits[t + 1] + kOverrunBits
                         : std::numeric_limits<int64_t>::max();
      speculative_worker(data, scan_start, chunk_byte[t], scan_end,
                         chunk_bits[t], stop, total_dus + P * 16,
                         total_dus / k + 4096, &units, &luts, t == 0,
                         t == 0 ? planes : nullptr, &chunks[t]);
    });
  }
  auto t_workers = std::chrono::steady_clock::now();

  if (dbg) {
    for (int t = 0; t < k; t++) {
      std::fprintf(stderr,
                   "[spec] chunk %d: base=%lld dus=%zu err=%d first=%lld "
                   "last=%lld\n",
                   t, (long long)chunk_bits[t], (size_t)chunks[t].n,
                   (int)chunks[t].error,
                   chunks[t].n == 0 ? -1LL : (long long)chunks[t].keys[0],
                   chunks[t].n == 0
                       ? -1LL
                       : (long long)chunks[t].keys[chunks[t].n - 1]);
    }
  }

  // Stitch: for each adjacent pair find the first common (position, phase)
  // key at or after the later chunk's start. first_valid[t] = first valid
  // DU index in chunk t; last_valid[t] = one-past-last.
  if (chunks[0].error) return JDT_ERR_BAD_ARG;  // real corruption: let the
                                                // serial path report it
  std::vector<int64_t> first_valid(k, 0), last_valid(k, 0);
  first_valid[0] = 0;
  for (int t = 0; t + 1 < k; t++) {
    const int64_t* a = chunks[t].keys.data();
    const int64_t an = chunks[t].n;
    const int64_t* b = chunks[t + 1].keys.data();
    const int64_t bn = chunks[t + 1].n;
    int64_t bi = 0, sync_a = -1, sync_b = -1;
    // advance a to the overlap region (keys are strictly monotone, so a
    // binary search replaces the linear walk over the whole chunk)
    int64_t ai = std::lower_bound(a, a + an, chunk_bits[t + 1] * P) - a;
    while (ai < an && bi < bn) {
      if (a[ai] == b[bi]) {
        sync_a = ai;
        sync_b = bi;
        break;
      }
      if (a[ai] < b[bi]) ai++; else bi++;
    }
    if (sync_a < 0) {
      if (dbg)
        std::fprintf(stderr, "[spec] no sync between %d and %d\n", t, t + 1);
      return JDT_ERR_BAD_ARG;  // no sync: fallback
    }
    if (dbg)
      std::fprintf(stderr,
                   "[spec] sync %d->%d at bit %lld phase %d (a#%lld b#%lld)\n",
                   t, t + 1, (long long)(a[sync_a] / P), (int)(a[sync_a] % P),
                   (long long)sync_a, (long long)sync_b);
    last_valid[t] = sync_a;          // chunk t contributes [first, sync_a)
    first_valid[t + 1] = sync_b;     // chunk t+1 valid from sync_b on
  }
  last_valid[k - 1] = chunks[k - 1].n;
  // The last worker has no DU-count target of its own and may run into the
  // stream's 1-fill padding after the final real data unit (flagging a
  // truncation "error") — trailing overshoot is trimmed by the global
  // count; a SHORTFALL means real desync and forces the fallback.
  int64_t total = 0;
  for (int t = 0; t < k; t++) total += last_valid[t] - first_valid[t];
  if (total > total_dus) {
    int64_t excess = total - total_dus;
    if (last_valid[k - 1] - first_valid[k - 1] < excess)
      return JDT_ERR_BAD_ARG;
    last_valid[k - 1] -= excess;
    total = total_dus;
  }
  if (total != total_dus) {
    if (dbg)
      std::fprintf(stderr, "[spec] total %lld != expected %lld\n",
                   (long long)total, (long long)total_dus);
    return JDT_ERR_BAD_ARG;
  }

  // Phase-lattice safety net: each chunk's first valid DU must sit at the
  // phase its global index implies (chunk 0 anchors the absolute lattice).
  // A mismatch can only come from a corrupt stream confusing the stitch.
  {
    int64_t idx = 0;
    for (int t = 0; t < k; t++) {
      if (last_valid[t] > first_valid[t]) {
        int ph = static_cast<int>(chunks[t].keys[first_valid[t]] % P);
        if (ph != static_cast<int>(idx % P)) {
          if (dbg)
            std::fprintf(stderr, "[spec] phase lattice mismatch at chunk %d\n",
                         t);
          return JDT_ERR_BAD_ARG;
        }
      }
      idx += last_valid[t] - first_valid[t];
    }
  }

  // Scatter with per-scan-component DC prefix sums (no restarts: one
  // predictor chain per component over the whole scan). Per-chunk starting
  // predictors and DU-index bases are computed serially (cheap adds), then
  // each chunk scatters concurrently.
  std::vector<int64_t> idx_base(k, 0);
  std::vector<std::array<int32_t, 4>> pred_base(k);
  {
    // Per-chunk per-component diff sums in parallel, then a serial combine
    // of k tiny vectors — the only serial dependence between chunks.
    std::vector<std::array<int32_t, 4>> sums(k, {0, 0, 0, 0});
    {
      int64_t idx0 = 0;
      std::vector<int64_t> idx_start(k);
      for (int t = 0; t < k; t++) {
        idx_start[t] = idx0;
        idx0 += last_valid[t] - first_valid[t];
      }
      std::atomic<int> pnext(0);
      pool_run(std::min(workers, k), [&](int) {
        for (;;) {
          int t = pnext.fetch_add(1);
          if (t >= k) break;
          const int32_t* dcs = chunks[t].dcs.data();
          int64_t idx = idx_start[t];
          std::array<int32_t, 4> acc = {0, 0, 0, 0};
          for (int64_t j = first_valid[t]; j < last_valid[t]; j++, idx++)
            acc[units[idx % P].scomp] += dcs[j];
          sums[t] = acc;
        }
      });
    }
    int64_t idx = 0;
    std::array<int32_t, 4> preds = {0, 0, 0, 0};
    for (int t = 0; t < k; t++) {
      idx_base[t] = idx;
      pred_base[t] = preds;
      for (int c = 0; c < 4; c++) preds[c] += sums[t][c];
      idx += last_valid[t] - first_valid[t];
    }
  }
  auto scatter = [&](int t) {
    int64_t idx = idx_base[t];
    std::array<int32_t, 4> preds = pred_base[t];
    int16_t scratch[64];
    // Incrementally-maintained block coordinates per unit-in-MCU (same
    // pattern as RegStream's ubx/uby): the straightforward form costs four
    // 64-bit div/mods per DU, which dominates this 128-byte-copy loop.
    int64_t m0 = idx / P;
    int u = static_cast<int>(idx % P);
    int32_t ubx[kRegMaxUnits];
    int32_t uby[kRegMaxUnits];
    for (int q = 0; q < P; q++) {
      const UnitLayout& ul = units[q];
      int64_t base = m0 * ul.h + ul.k;
      ubx[q] = static_cast<int32_t>(base % ul.wrap);
      uby[q] = static_cast<int32_t>((base / ul.wrap) * ul.v + ul.j);
    }
    for (int64_t j = first_valid[t]; j < last_valid[t]; j++) {
      const int16_t* du = chunks[t].dus.data() + j * 64;
      const UnitLayout& ul = units[u];
      int32_t bx = ubx[u];
      int32_t by = uby[u];
      int16_t* dst = (by < ul.plane_bh && bx < ul.plane_bw)
                         ? planes[ul.plane] + ((int64_t)by * ul.plane_bw + bx) * 64
                         : scratch;
      preds[ul.scomp] += du[0];
      const int16_t dc = static_cast<int16_t>(preds[ul.scomp]);
      // Stream the plane write (the plane line is not re-read on the host
      // before the device transfer; a regular store would read-for-
      // ownership every 128-byte destination first). The DC is patched
      // into lane 0 of the first vector before it leaves the core.
#if defined(__SSE2__)
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        const __m128i* s = reinterpret_cast<const __m128i*>(du);
        __m128i* d = reinterpret_cast<__m128i*>(dst);
        _mm_stream_si128(d + 0,
                         _mm_insert_epi16(_mm_loadu_si128(s + 0), dc, 0));
        _mm_stream_si128(d + 1, _mm_loadu_si128(s + 1));
        _mm_stream_si128(d + 2, _mm_loadu_si128(s + 2));
        _mm_stream_si128(d + 3, _mm_loadu_si128(s + 3));
        _mm_stream_si128(d + 4, _mm_loadu_si128(s + 4));
        _mm_stream_si128(d + 5, _mm_loadu_si128(s + 5));
        _mm_stream_si128(d + 6, _mm_loadu_si128(s + 6));
        _mm_stream_si128(d + 7, _mm_loadu_si128(s + 7));
      } else
#endif
      {
        std::memcpy(dst, du, 64 * sizeof(int16_t));
        dst[0] = dc;
      }
      if (++u == P) {
        u = 0;
        for (int q = 0; q < P; q++) {
          const UnitLayout& uq = units[q];
          ubx[q] += uq.h;
          while (ubx[q] >= uq.wrap) {
            ubx[q] -= uq.wrap;
            uby[q] += uq.v;
          }
        }
      }
    }
  };
  // Chunk 0 already decoded directly into the planes; scatter the rest
  // (dynamic grab, workers-capped: the per-chunk scatter is memory-bound,
  // extra threads only thrash).
  auto t_stitch = std::chrono::steady_clock::now();
  {
    std::atomic<int> snext(1);
    pool_run(std::min(workers, k - 1), [&](int) {
      for (;;) {
        int t = snext.fetch_add(1);
        if (t >= k) break;
        scatter(t);
      }
      // Plane lines were written with streaming stores; publish them
      // before this worker reports done.
      spec_store_fence();
    });
  }
  if (dbg) {
    auto t_done = std::chrono::steady_clock::now();
    auto ms = [](auto a, auto b) {
      return std::chrono::duration<double, std::milli>(b - a).count();
    };
    std::fprintf(stderr, "[spec] workers=%.2fms stitch=%.2fms scatter=%.2fms\n",
                 ms(t_setup, t_workers), ms(t_workers, t_stitch),
                 ms(t_stitch, t_done));
  }
  return JDT_OK;
}

// Chunk-parallel entropy-span prescan core, shared by jdt_scan_span (the
// classic parse-time entry) and jdt_scan_decode (the fused prescan+decode
// entry). 0xFF classification is LOCAL (each 0xFF is judged by its next
// byte), so the walk parallelizes by byte chunks: the only boundary hazard
// is a pair straddling a chunk edge, resolved by one look-back byte (a
// chunk whose predecessor ends in a consumed 0xFF skips its first byte).
// Large single-scan spans split across the worker pool; small spans stay
// serial. Results go to vectors (no caps).
void scan_span_core(const uint8_t* data, int64_t n, int64_t start,
                    int32_t n_threads, int64_t* end_out,
                    std::vector<int64_t>& rst, std::vector<int64_t>* stuff) {
  int64_t span = n - start;
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  int C = 1;
  if (span > (1 << 20))
    C = static_cast<int>(
        std::min<int64_t>(n_threads, span >> 19));  // >= 512 KiB per chunk
  struct ChunkRes {
    std::vector<int64_t> rst;
    std::vector<int64_t> stuff;
    int64_t end = -1;  // -1: no terminator in this chunk
  };
  std::vector<int64_t> cb(C + 1);
  for (int t = 0; t <= C; t++) cb[t] = start + span * t / C;
  std::vector<ChunkRes> res(C);
  auto scan_chunk = [&](int t) {
    int64_t i = cb[t];
    const int64_t lim = cb[t + 1];
    // Boundary fix: if the previous chunk's last byte is an 0xFF that
    // consumed this chunk's first byte (stuffing or RSTn second byte),
    // skip it; an 0xFF fill byte consumes nothing.
    if (t > 0 && data[i - 1] == 0xFF && data[i] != 0xFF) i++;
    ChunkRes& r = res[t];
    while (i < lim) {
      const void* hit = std::memchr(data + i, 0xFF, lim - i);
      if (hit == nullptr) break;
      i = static_cast<const uint8_t*>(hit) - data;
      if (i + 1 >= n) {  // trailing 0xFF at EOF terminates the scan
        r.end = i;
        break;
      }
      uint8_t nxt = data[i + 1];
      if (nxt == 0x00) {
        if (stuff != nullptr) r.stuff.push_back(i);
        i += 2;  // stuffed
      } else if (nxt >= 0xD0 && nxt <= 0xD7) {
        r.rst.push_back(i);
        i += 2;
      } else if (nxt == 0xFF) {
        i += 1;  // fill byte: re-examine from the next 0xFF
      } else {
        r.end = i;
        break;
      }
    }
  };
  if (C <= 1) {
    scan_chunk(0);
  } else {
    pool_run(C, scan_chunk);
  }
  int64_t end = n;
  for (int t = 0; t < C; t++) {
    rst.insert(rst.end(), res[t].rst.begin(), res[t].rst.end());
    if (stuff != nullptr)
      stuff->insert(stuff->end(), res[t].stuff.begin(), res[t].stuff.end());
    if (res[t].end >= 0) {
      end = res[t].end;
      break;  // later chunks scanned past this scan's end: discard
    }
  }
  *end_out = end;
}

}  // namespace

extern "C" {

int32_t jdt_version() { return 12; }

// Entropy-span prescan: find where a scan's entropy bytes end and every
// in-scan RSTn offset, classifying each 0xFF as stuffing (next 0x00),
// restart marker (0xD0-0xD7), fill byte (next 0xFF, spec B.1.1.2), or the
// scan terminator. memchr-based: the libc SIMD scan replaces the NumPy
// whole-buffer passes (io/bitstream.scan_entropy_span is the semantic
// reference; both must classify identically). Returns 0 on success, 1 if
// more than max_rst restart markers were found (caller falls back).
// stuff_out (optional, may be null): offsets of each stuffed 0xFF, for the
// index-driven unstuff in the decode stage; *n_stuff_out = -1 signals
// overflow past max_stuff (decode falls back to per-segment memchr).
int32_t jdt_scan_span(const uint8_t* data, int64_t n, int64_t start,
                      int64_t* end_out, int64_t* rst_out, int64_t max_rst,
                      int64_t* n_rst_out, int32_t n_threads,
                      int64_t* stuff_out, int64_t max_stuff,
                      int64_t* n_stuff_out) {
  std::vector<int64_t> rst;
  std::vector<int64_t> stuff;
  scan_span_core(data, n, start, n_threads, end_out, rst,
                 stuff_out != nullptr ? &stuff : nullptr);
  int64_t nr = static_cast<int64_t>(rst.size());
  int64_t nc = std::min(nr, max_rst);
  if (nc > 0)  // empty vector: .data() may be null (UB for memcpy even n=0)
    std::memcpy(rst_out, rst.data(),
                static_cast<size_t>(nc) * sizeof(int64_t));
  *n_rst_out = nr;
  if (stuff_out != nullptr) {
    int64_t ns = static_cast<int64_t>(stuff.size());
    if (ns > max_stuff) {
      *n_stuff_out = -1;  // overflow: decode falls back to memchr unstuff
    } else {
      if (ns > 0)
        std::memcpy(stuff_out, stuff.data(),
                    static_cast<size_t>(ns) * sizeof(int64_t));
      *n_stuff_out = ns;
    }
  } else if (n_stuff_out != nullptr) {
    *n_stuff_out = -1;
  }
  return nr > max_rst ? 1 : 0;
}

// Fused prescan + sequential decode: one native call runs the entropy-span
// prescan (restart cuts, stuffed-0xFF index, scan terminator) and the
// segment-parallel decode, eliminating the per-image Python round trip
// between them (scan_span wrapper + offset-array copies + Scan-object
// rebuild, ~0.4 ms/image on the 4K serving path). The span end is returned
// so the caller's marker walk can resume after the scan.
//
// allow_spec: when the scan has no restart markers, attempt the
// speculative self-synchronizing chunk-parallel decode first (same engine
// as jdt_decode_sequential_spec); it verifies its own sync and falls back
// to the serial path inside this call on any anomaly.
//
// Returns JDT_OK or a decode status; JDT_ERR_SEG_COUNT means the restart
// marker count is inconsistent with `ri` (caller raises the same typed
// error the classic path does, with *n_segs_out for the message).
int32_t jdt_scan_decode(const uint8_t* data, int64_t n, int64_t start,
                        int64_t total_mcus, int64_t ri,
                        const int32_t* unit_params, int32_t n_units,
                        const uint16_t* const* lut12s,
                        const uint16_t* const* lut16s,
                        const int32_t* const* vluts,
                        const uint64_t* const* vlut2s, int32_t n_luts,
                        int16_t** planes, int32_t n_threads,
                        int32_t allow_spec, int64_t* end_out,
                        int64_t* n_segs_out, int64_t* err_out) {
  if (n_units <= 0 || n_luts <= 0 || total_mcus <= 0 || start < 0 ||
      start > n)
    return JDT_ERR_BAD_ARG;
  std::vector<int64_t> rst;
  std::vector<int64_t> stuff;
  scan_span_core(data, n, start, n_threads, end_out, rst, &stuff);
  int64_t end = *end_out;
  int64_t n_segs = static_cast<int64_t>(rst.size()) + 1;
  *n_segs_out = n_segs;
  // Same structure rule as the Python _check_segments: restart markers
  // with no DRI would desync the reference; a count mismatch against
  // ceil(total_mcus / ri) is malformed.
  if (ri == 0) {
    if (n_segs != 1) return JDT_ERR_SEG_COUNT;
  } else if (n_segs != (total_mcus + ri - 1) / ri) {
    return JDT_ERR_SEG_COUNT;
  }
  std::vector<int64_t> bounds(2 * n_segs);
  int64_t s = start;
  for (int64_t i = 0; i < n_segs - 1; i++) {
    bounds[2 * i] = s;
    bounds[2 * i + 1] = rst[i];
    s = rst[i] + 2;
  }
  bounds[2 * (n_segs - 1)] = s;
  bounds[2 * (n_segs - 1) + 1] = end;

  std::vector<UnitLayout> units_v(n_units);
  for (int32_t u = 0; u < n_units; u++) {
    const int32_t* q = unit_params + u * 11;
    units_v[u] = UnitLayout{q[0], q[1], q[2], q[3], q[4], q[5],
                            q[6], q[7], q[8], q[9], q[10]};
  }
  std::vector<HuffLut> luts_v(n_luts);
  for (int32_t t = 0; t < n_luts; t++)
    luts_v[t] = HuffLut{lut12s[t], lut16s[t], vluts[t], nullptr,
                        vlut2s != nullptr ? vlut2s[t] : nullptr};

  int resolved = n_threads > 0
                     ? n_threads
                     : static_cast<int>(std::thread::hardware_concurrency());
  if (n_segs == 1 && allow_spec && resolved > 1 &&
      total_mcus * n_units >= 4096) {
    int rc = decode_speculative(data, start, end, total_mcus, units_v,
                                luts_v, planes, n_threads, stuff.data(),
                                static_cast<int64_t>(stuff.size()));
    if (rc != JDT_ERR_BAD_ARG) return rc;  // OK or a real decode error
    // BAD_ARG = could not apply/synchronize: serial fallback below
    // (chunk 0 decoded directly into the planes, but the serial pass
    // overwrites every block the scan covers).
  }

  ScanContext c;
  c.data = data;
  c.seg_bounds = bounds.data();
  c.n_segs = n_segs;
  c.total_mcus = total_mcus;
  c.ri = ri;
  c.units = std::move(units_v);
  c.luts = std::move(luts_v);
  c.planes = planes;
  c.stuff = stuff.data();
  c.n_stuff = static_cast<int64_t>(stuff.size());
  if (n_segs >= 2 && n_units <= kRegMaxUnits)
    return reg_run<4>(c, n_threads, err_out);
  return run_segments(c, n_threads, err_out, decode_segment_sequential);
}

// Sequential (baseline/extended) scan, segment-parallel.
// unit_params: n_units x 11 int32 (see UnitLayout). err_out: [seg, mcu].
int32_t jdt_decode_sequential(const uint8_t* data, const int64_t* seg_bounds,
                              int64_t n_segs, int64_t total_mcus, int64_t ri,
                              const int32_t* unit_params, int32_t n_units,
                              const uint16_t* const* lut12s,
                              const uint16_t* const* lut16s,
                              const int32_t* const* vluts,
                              const int32_t* const* pvluts,
                              const uint64_t* const* vlut2s,
                              int32_t n_luts, int16_t** planes,
                              int32_t n_threads, int64_t* err_out,
                              const int64_t* stuff, int64_t n_stuff) {
  if (n_segs <= 0 || n_units <= 0 || n_luts <= 0) return JDT_ERR_BAD_ARG;
  ScanContext c = build_context(data, seg_bounds, n_segs, total_mcus, ri,
                                unit_params, n_units, lut12s, lut16s, vluts,
                                pvluts, vlut2s, n_luts, planes);
  c.stuff = stuff;
  c.n_stuff = n_stuff;
  // Multi-segment scans take the register-resident multi-stream path: 4
  // interleaved streams per worker overlap their dependent LUT-load chains
  // (34 ms vs 67 ms single-thread on the 4K q85 microbench). A single
  // segment has no second stream to interleave — the BitReader drain loop
  // is faster there (67 ms vs 81 ms).
  if (n_segs >= 2 && n_units <= kRegMaxUnits) {
    // K=4 streams per worker: the sweep plateau, confirmed three times
    // (K=2/3/4/5/6/8 = 41.8/36.5/34.6/34.5/35.9/36.3 ms 1-thread, and a
    // K=4-vs-5 tie at 4 threads on a quiet machine — PERF.md). The
    // JDT_REG_K re-sweep hook was retired in round 4; re-instantiate
    // reg_run<K> here to re-measure on new hardware.
    return reg_run<4>(c, n_threads, err_out);
  }
  return run_segments(c, n_threads, err_out, decode_segment_sequential);
}

// Speculative chunk-parallel decode of a no-restart sequential scan —
// single-component OR interleaved (phase folded into the sync key; see
// decode_speculative above). Returns JDT_OK on success; JDT_ERR_BAD_ARG
// means "could not apply/synchronize" and the caller should use
// jdt_decode_sequential instead.
int32_t jdt_decode_sequential_spec(
    const uint8_t* data, int64_t scan_start, int64_t scan_end,
    int64_t total_mcus, const int32_t* unit_params, int32_t n_units,
    const uint16_t* const* lut12s, const uint16_t* const* lut16s,
    const int32_t* const* vluts, const uint64_t* const* vlut2s,
    int32_t n_luts, int16_t** planes,
    int32_t n_threads, const int64_t* stuff, int64_t n_stuff) {
  if (total_mcus <= 0 || n_units <= 0 || n_units > 10 || n_luts <= 0)
    return JDT_ERR_BAD_ARG;
  std::vector<UnitLayout> units(n_units);
  for (int32_t u = 0; u < n_units; u++) {
    const int32_t* q = unit_params + u * 11;
    units[u] = UnitLayout{q[0], q[1], q[2], q[3], q[4], q[5],
                          q[6], q[7], q[8], q[9], q[10]};
  }
  std::vector<HuffLut> luts(n_luts);
  for (int32_t t = 0; t < n_luts; t++)
    luts[t] = HuffLut{lut12s[t], lut16s[t], vluts[t], nullptr,
                      vlut2s ? vlut2s[t] : nullptr};
  return decode_speculative(data, scan_start, scan_end, total_mcus, units,
                            luts, planes, n_threads, stuff, n_stuff);
}

// Progressive scan (any of the four pass kinds), segment-parallel.
int32_t jdt_decode_progressive(const uint8_t* data, const int64_t* seg_bounds,
                               int64_t n_segs, int64_t total_mcus, int64_t ri,
                               const int32_t* unit_params, int32_t n_units,
                               const uint16_t* const* lut12s,
                               const uint16_t* const* lut16s,
                               const int32_t* const* vluts,
                               const int32_t* const* pvluts,
                               int32_t n_luts, int16_t** planes,
                               int32_t ss, int32_t se, int32_t ah, int32_t al,
                               int32_t n_threads, int64_t* err_out) {
  if (n_segs <= 0 || n_units <= 0) return JDT_ERR_BAD_ARG;
  ScanContext c = build_context(data, seg_bounds, n_segs, total_mcus, ri,
                                unit_params, n_units, lut12s, lut16s, vluts,
                                pvluts, nullptr, n_luts, planes);
  ProgParams pp{ss, se, ah, al};
  return run_segments(c, n_threads, err_out,
                      [&pp](const ScanContext& ctx, int64_t seg,
                            int64_t* err_mcu) {
                        return decode_segment_progressive(ctx, pp, seg,
                                                          err_mcu);
                      });
}

}  // extern "C"
