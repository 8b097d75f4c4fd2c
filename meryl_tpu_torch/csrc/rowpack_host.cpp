// The set-op evaluator's row packing (optree.BucketEvaluator._pack_rows and
// _pack_flat) in one native pass.
//
// Built by g++ into a shared library with a plain C interface and called
// through ctypes, which releases the GIL for the whole call.
//
// The inputs are m sorted (hi, lo) runs of unsigned 64-bit words with
// their counts, each count 4 bytes (u32, widened with zeros) or 8 bytes
// (int64, taken as it is).  The output is R rows of L slots: keys as
// int64 words (`words` a slot, most significant first, each the unsigned
// word XOR 2^63), values as int64 and input ids as int32.
//
// mt_rowpack_bounds writes each input's R + 1 row bounds: 0, the
// lexicographic lower bound of each of the R - 1 cut keys, and the input's
// length.  -> the fullest row's occupancy, the entries of all inputs that
// fall in it.
// mt_rowpack_fill writes every slot once: each row holds input 0's slice,
// then input 1's, and so on, then the sentinel key, value 0 and id pad_id
// to its end.  `threads` write disjoint ranges of the R * L slots.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFlip = 1ull << 63;

struct Inputs {
  const uint64_t* const* his;
  const uint64_t* const* los;
  const void* const* counts;
  const int32_t* count_bytes;
};

// First index of the sorted (hi, lo) run whose key is not below (h, l).
inline int64_t lower_bound(const uint64_t* hi, const uint64_t* lo, int64_t n,
                           uint64_t h, uint64_t l) {
  int64_t base = 0, len = n;
  while (len > 0) {
    const int64_t half = len >> 1;
    const int64_t i = base + half;
    if (hi[i] < h || (hi[i] == h && lo[i] < l)) {
      base = i + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return base;
}

// f(t) for t in [0, threads): t = 0 on the calling thread.
template <class F>
void parallel(int threads, F f) {
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(f, t);
  f(0);
  for (auto& th : pool) th.join();
}

struct Out {
  int32_t words;
  int64_t sent_hi, sent_lo;
  int64_t* keys;
  int64_t* values;
  int32_t* ids;
};

// Input i's entries [s, s + n) into slots [o, o + n).
inline void put_input(const Inputs& in, const Out& out, int32_t i, int64_t s,
                      int64_t n, int64_t o) {
  const uint64_t* lo = in.los[i] + s;
  if (out.words == 1) {
    int64_t* k = out.keys + o;
    for (int64_t x = 0; x < n; ++x) k[x] = static_cast<int64_t>(lo[x] ^ kFlip);
  } else {
    const uint64_t* hi = in.his[i] + s;
    int64_t* k = out.keys + 2 * o;
    for (int64_t x = 0; x < n; ++x) {
      k[2 * x] = static_cast<int64_t>(hi[x] ^ kFlip);
      k[2 * x + 1] = static_cast<int64_t>(lo[x] ^ kFlip);
    }
  }
  int64_t* v = out.values + o;
  if (in.count_bytes[i] == 4) {
    const uint32_t* c = static_cast<const uint32_t*>(in.counts[i]) + s;
    for (int64_t x = 0; x < n; ++x) v[x] = c[x];
  } else {
    const int64_t* c = static_cast<const int64_t*>(in.counts[i]) + s;
    std::copy(c, c + n, v);
  }
  std::fill(out.ids + o, out.ids + o + n, i);
}

// Padding into slots [o, o + n).
inline void put_tail(const Out& out, int32_t pad_id, int64_t n, int64_t o) {
  if (out.words == 1) {
    std::fill(out.keys + o, out.keys + o + n, out.sent_lo);
  } else {
    int64_t* k = out.keys + 2 * o;
    for (int64_t x = 0; x < n; ++x) {
      k[2 * x] = out.sent_hi;
      k[2 * x + 1] = out.sent_lo;
    }
  }
  std::fill(out.values + o, out.values + o + n, 0);
  std::fill(out.ids + o, out.ids + o + n, pad_id);
}

}  // namespace

extern "C" int64_t mt_rowpack_bounds(int32_t m, const uint64_t* const* his,
                                     const uint64_t* const* los,
                                     const int64_t* lens,
                                     const uint64_t* cut_hi,
                                     const uint64_t* cut_lo, int64_t R,
                                     int64_t* bounds) {
  std::vector<int64_t> occ(R, 0);
  for (int32_t i = 0; i < m; ++i) {
    int64_t* b = bounds + i * (R + 1);
    b[0] = 0;
    for (int64_t j = 0; j + 1 < R; ++j)
      b[j + 1] = lower_bound(his[i], los[i], lens[i], cut_hi[j], cut_lo[j]);
    b[R] = lens[i];
    for (int64_t r = 0; r < R; ++r) occ[r] += b[r + 1] - b[r];
  }
  return R ? *std::max_element(occ.begin(), occ.end()) : 0;
}

extern "C" void mt_rowpack_fill(int32_t m, const uint64_t* const* his,
                                const uint64_t* const* los,
                                const void* const* counts,
                                const int32_t* count_bytes,
                                const int64_t* bounds, int64_t R, int64_t L,
                                int32_t pad_id, int32_t words,
                                int64_t sent_hi, int64_t sent_lo,
                                int64_t* keys, int64_t* values, int32_t* ids,
                                int32_t threads) {
  const Inputs in{his, los, counts, count_bytes};
  const Out out{words, sent_hi, sent_lo, keys, values, ids};
  const int64_t slots = R * L;
  const int t_n = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(threads, slots)));
  parallel(t_n, [&](int t) {
    const int64_t s0 = slots * t / t_n, s1 = slots * (t + 1) / t_n;
    for (int64_t r = s0 / L; r * L < s1; ++r) {
      // this thread's columns [c0, c1) of row r
      const int64_t c0 = std::max<int64_t>(s0 - r * L, 0);
      const int64_t c1 = std::min<int64_t>(s1 - r * L, L);
      int64_t col = 0;  // the row's next column
      for (int32_t i = 0; i < m && col < c1; ++i) {
        const int64_t* b = bounds + i * (R + 1);
        const int64_t a = std::max(col, c0);
        const int64_t e = std::min(col + b[r + 1] - b[r], c1);
        if (a < e) put_input(in, out, i, b[r] + a - col, e - a, r * L + a);
        col += b[r + 1] - b[r];
      }
      const int64_t a = std::max(col, c0);
      if (a < c1) put_tail(out, pad_id, c1 - a, r * L + a);
    }
  });
}
