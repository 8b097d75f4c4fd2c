// The one-card count's finalize tail (DeviceAccCounter.finalize) in one
// pass: decode the dense download and merge a small sorted run into it.
//
// Built by g++ into a shared library with a plain C interface and called
// through ctypes, which releases the GIL for the whole call.
//
// The download is what DeviceAccCounter._download_dense fetches: n sorted
// unique keys of `words` int64 words each (most significant first, each
// the unsigned word XOR 2^63, so signed order is unsigned order) and
// their n uint32 counts.  The small run is m sorted unique unsigned
// (hi, lo) keys with uint32 counts.
//
// mt_finalize_plan places each small key: pos = its lower bound in the
// download, hit = whether the download holds it.  -> the number of small
// keys the download lacks.
// mt_finalize_fill writes the merge, n + that many entries: the keys
// decoded to unsigned (hi, lo) (hi is not written for one-word keys),
// the counts of equal keys summed and every count clamped to 2^32 - 1.
// It cuts the download into `threads` ranges and fills each range's
// slice of the output from its known offset.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFlip = 1ull << 63;
constexpr uint64_t kValueMax = 0xFFFFFFFFull;

struct Download {
  const int64_t* keys;
  const uint32_t* counts;
  int64_t n;
  int words;

  uint64_t hi(int64_t i) const {
    return words == 1 ? 0 : static_cast<uint64_t>(keys[2 * i]) ^ kFlip;
  }
  uint64_t lo(int64_t i) const {
    return static_cast<uint64_t>(keys[words * i + words - 1]) ^ kFlip;
  }
  bool less(int64_t i, uint64_t h, uint64_t l) const {
    const uint64_t a = hi(i);
    return a < h || (a == h && lo(i) < l);
  }
};

// f(t) for t in [0, threads): t = 0 on the calling thread.
template <class F>
void parallel(int threads, F f) {
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(f, t);
  f(0);
  for (auto& th : pool) th.join();
}

// Download entries [i, e) decoded to output entries from o.
inline void copy_decode(const Download& d, int64_t i, int64_t e, int64_t o,
                        uint64_t* ohi, uint64_t* olo, uint32_t* oc) {
  const int64_t len = e - i;
  if (len <= 0) return;
  if (d.words == 1) {
    const int64_t* k = d.keys + i;
    uint64_t* l = olo + o;
    for (int64_t x = 0; x < len; ++x)
      l[x] = static_cast<uint64_t>(k[x]) ^ kFlip;
  } else {
    const int64_t* k = d.keys + 2 * i;
    uint64_t* h = ohi + o;
    uint64_t* l = olo + o;
    for (int64_t x = 0; x < len; ++x) {
      h[x] = static_cast<uint64_t>(k[2 * x]) ^ kFlip;
      l[x] = static_cast<uint64_t>(k[2 * x + 1]) ^ kFlip;
    }
  }
  std::copy(d.counts + i, d.counts + e, oc + o);
}

}  // namespace

extern "C" int64_t mt_finalize_plan(const int64_t* keys, int64_t n,
                                    int32_t words, const uint64_t* shi,
                                    const uint64_t* slo, int64_t m,
                                    int64_t* pos, uint8_t* hit,
                                    int32_t threads) {
  const Download d{keys, nullptr, n, words};
  const int t_n = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(threads, m >> 12)));
  parallel(t_n, [&](int t) {
    const int64_t j0 = m * t / t_n, j1 = m * (t + 1) / t_n;
    for (int64_t j = j0; j < j1; ++j) {
      const uint64_t h = shi[j], l = slo[j];
      int64_t base = 0, len = n;
      while (len > 0) {
        const int64_t half = len >> 1;
        if (d.less(base + half, h, l)) {
          base += half + 1;
          len -= half + 1;
        } else {
          len = half;
        }
      }
      pos[j] = base;
      hit[j] = base < n && d.hi(base) == h && d.lo(base) == l;
    }
  });
  int64_t fresh = 0;
  for (int64_t j = 0; j < m; ++j) fresh += !hit[j];
  return fresh;
}

extern "C" void mt_finalize_fill(const int64_t* keys, const uint32_t* counts,
                                 int64_t n, int32_t words,
                                 const uint64_t* shi, const uint64_t* slo,
                                 const uint32_t* sc, int64_t m,
                                 const int64_t* pos, const uint8_t* hit,
                                 uint64_t* ohi, uint64_t* olo, uint32_t* oc,
                                 int32_t threads) {
  const Download d{keys, counts, n, words};
  const int t_n = std::max(1, threads);
  // fresh[j]: the small keys before j that the download lacks
  std::vector<int64_t> fresh(m + 1, 0);
  for (int64_t j = 0; j < m; ++j) fresh[j + 1] = fresh[j] + !hit[j];
  parallel(t_n, [&](int t) {
    const int64_t a = n * t / t_n, b = n * (t + 1) / t_n;
    // this range's small keys: those placed before one of its entries,
    // and past the last entry for the last range
    const int64_t j0 = std::lower_bound(pos, pos + m, a) - pos;
    const int64_t j1 =
        t + 1 == t_n ? m : std::lower_bound(pos, pos + m, b) - pos;
    int64_t i = a, o = a + fresh[j0];
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t p = pos[j];
      copy_decode(d, i, p, o, ohi, olo, oc);
      o += p - i;
      i = p;
      if (hit[j]) {
        if (words == 2) ohi[o] = d.hi(i);
        olo[o] = d.lo(i);
        oc[o] = static_cast<uint32_t>(std::min<uint64_t>(
            uint64_t{counts[i]} + sc[j], kValueMax));
        ++i;
      } else {
        if (words == 2) ohi[o] = shi[j];
        olo[o] = slo[j];
        oc[o] = sc[j];
      }
      ++o;
    }
    copy_decode(d, i, b, o, ohi, olo, oc);
  });
}
