// The count reader's 2-bit pack (kmer.pack_codes_2bit) in one pass.
//
// Built by g++ into a shared library with a plain C interface and called
// through ctypes, which releases the GIL for the whole call, so the
// reader thread packs while the main thread dispatches.
//
// codes: n bytes, 0..3 a base (A C T G), anything else an exception.
// Writes L / 16 words of 16 codes each (code j of word w at bits
// 2 * (j mod 16); an exception and the padding past n pack as 0), the
// positions of the exceptions below the last valid code, in order, as
// int32 (at most `cap` of them), and n_real = 1 + that last position.
// Returns the number of those exceptions, which may exceed `cap`: the
// caller then calls again with a larger list.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kHigh6 = 0xFCFCFCFCFCFCFCFCull;  // bits of a byte > 3
constexpr uint64_t kLow7 = 0x7F7F7F7F7F7F7F7Full;
constexpr uint64_t kTop = 0x8080808080808080ull;

// 0x80 in each byte of w that is not a code 0..3, 0 elsewhere.
inline uint64_t bad_bytes(uint64_t w) {
  const uint64_t x = w & kHigh6;
  return (((x & kLow7) + kLow7) | x) & kTop;
}

// Eight codes 0..3, one a byte (little-endian) -> 16 bits, code j at
// bits 2j.
inline uint32_t pack8(uint64_t w) {
  w = (w | (w >> 6)) & 0x000F000F000F000Full;   // two codes a 16-bit lane
  w = (w | (w >> 12)) & 0x000000FF000000FFull;  // four codes a 32-bit lane
  return static_cast<uint32_t>((w | (w >> 24)) & 0xFFFF);
}

struct State {
  int32_t* exc;
  int64_t cap;
  int64_t ne;    // exceptions seen, past the last valid code too
  int64_t last;  // last valid position, -1 before the first
};

// Eight bytes at position `base`, of which the bytes in `lanes` (0x80 a
// byte) are codes: records their exceptions and last valid position,
// -> the 16 bits they pack to.
inline uint32_t half(uint64_t w, int64_t base, uint64_t lanes, State& st) {
  const uint64_t bad = bad_bytes(w);
  if (bad) {
    w &= ~((bad >> 7) * 0xFF);  // an exception packs as 0
    for (uint64_t m = bad & lanes; m; m &= m - 1) {
      if (st.ne < st.cap)
        st.exc[st.ne] = static_cast<int32_t>(base + (__builtin_ctzll(m) >> 3));
      ++st.ne;
    }
  }
  const uint64_t good = ~bad & lanes;
  if (good) st.last = base + ((63 - __builtin_clzll(good)) >> 3);
  return pack8(w);
}

}  // namespace

extern "C" int64_t mt_pack_2bit(const uint8_t* codes, int64_t n, int64_t L,
                                uint32_t* packed, int32_t* exc, int64_t cap,
                                int64_t* n_real) {
  State st{exc, cap, 0, -1};
  const int64_t full = n & ~int64_t{15};
  for (int64_t i = 0; i < full; i += 16) {
    uint64_t lo, hi;
    std::memcpy(&lo, codes + i, 8);
    std::memcpy(&hi, codes + i + 8, 8);
    if (((lo | hi) & kHigh6) == 0) {  // sixteen bases, no exception
      packed[i >> 4] = pack8(lo) | (pack8(hi) << 16);
      st.last = i + 15;
    } else {
      packed[i >> 4] = half(lo, i, kTop, st) | (half(hi, i + 8, kTop, st) << 16);
    }
  }
  int64_t w = full >> 4;
  if (full < n) {  // the last n - full codes; the rest of the word is 0
    uint8_t buf[16];
    std::memset(buf, 0xFF, sizeof buf);
    std::memcpy(buf, codes + full, static_cast<size_t>(n - full));
    const int m = static_cast<int>(n - full);
    uint64_t lo, hi;
    std::memcpy(&lo, buf, 8);
    std::memcpy(&hi, buf + 8, 8);
    const uint64_t lanes_lo = m >= 8 ? kTop : kTop & ((1ull << (8 * m)) - 1);
    const uint64_t lanes_hi =
        m <= 8 ? 0 : kTop & ((1ull << (8 * (m - 8))) - 1);
    packed[w++] = half(lo, full, lanes_lo, st) |
                  (half(hi, full + 8, lanes_hi, st) << 16);
  }
  for (; w < (L >> 4); ++w) packed[w] = 0;
  *n_real = st.last + 1;
  // every position from n_real to n is an exception: drop them
  return st.ne - (n - *n_real);
}
