// The DB writer (db.MerylDB.write, db.MerylDBWriter.add_bucket) in one
// native pass.
//
// Built by g++ into a shared library with a plain C interface and called
// through ctypes, which releases the GIL for the whole call.
//
// mt_db_write writes the bucket files of sorted (hi, lo, counts[, labels])
// entries, byte for byte as db._write_bucket does: the 24-byte header, lo,
// hi, the counts narrowed to u32, then the labels masked and narrowed to
// label_bytes each.  With ff < 0 it writes all 64 files, the bounds found
// by binary search on the 6-bit prefix (db's prefix6, which is monotone in
// sorted order); with ff >= 0 it writes every entry to that one file.  In
// the same pass it counts the narrowed counts' histogram (dense below
// kDense, a sorted list above) and their statistics.  `threads` > 1 writes
// the files from that many threads, each claiming the largest file left.
//
// Returns a handle: mt_db_info reads its error, failed file, statistics
// and histogram length, mt_db_finish copies the histogram out and frees it.

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <new>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr int kFiles = 64;
constexpr uint32_t kDense = 1u << 14;  // histogram values counted densely
constexpr int64_t kChunk = 1 << 16;    // entries narrowed a write

struct Input {
  const char* dir;
  const uint64_t* hi;
  const uint64_t* lo;
  const void* counts;
  int32_t count_bytes;  // 4 or 8
  const uint64_t* labels;
  uint64_t label_mask;
  int32_t label_bytes;  // 1, 2, 4 or 8
  uint32_t k;
  uint32_t flags;
};

struct Tally {  // one thread's histogram and total
  std::vector<uint64_t> dense = std::vector<uint64_t>(kDense, 0);
  std::vector<uint32_t> over;
  uint64_t total = 0;
};

struct Result {
  uint64_t err = 0;     // errno of the first failure
  uint64_t failed = 0;  // its file, kFiles for none in particular
  uint64_t n_unique = 0;
  uint64_t n_total = 0;
  std::vector<uint64_t> vals, occ;
};

// db's prefix6_from_hilo for one entry.
inline uint32_t prefix6(uint64_t hi, uint64_t lo, int k) {
  const int shift = 2 * k - 6;
  if (shift < 0) return static_cast<uint32_t>((lo << -shift) & 63);
  if (shift >= 64) return static_cast<uint32_t>((hi >> (shift - 64)) & 63);
  if (2 * k <= 64) return static_cast<uint32_t>((lo >> shift) & 63);
  const int nhi = 2 * k - 64, need_lo = 6 - nhi;
  const uint64_t top = ((hi & ((1ull << nhi) - 1)) << need_lo) |
                       (lo >> (64 - need_lo));
  return static_cast<uint32_t>(top & 63);
}

int write_all(int fd, const void* p, size_t n) {
  const char* c = static_cast<const char*>(p);
  while (n) {
    const ssize_t w = ::write(fd, c, std::min<size_t>(n, size_t{1} << 30));
    if (w < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    c += w;
    n -= static_cast<size_t>(w);
  }
  return 0;
}

inline void tally(Tally& t, uint32_t v) {
  if (v < kDense)
    ++t.dense[v];
  else
    t.over.push_back(v);
  t.total += v;
}

// Entries [b, e) to the open file fd -> 0 or errno.
int write_entries(int fd, const Input& in, int64_t b, int64_t e, Tally& t,
                  std::vector<uint32_t>& cbuf, std::vector<uint8_t>& lbuf) {
  const uint64_t n = static_cast<uint64_t>(e - b);
  unsigned char head[24];
  std::memcpy(head, "MTPUKMB1", 8);
  std::memcpy(head + 8, &in.k, 4);
  std::memcpy(head + 12, &in.flags, 4);
  std::memcpy(head + 16, &n, 8);
  int err = write_all(fd, head, sizeof head);
  if (!err) err = write_all(fd, in.lo + b, n * 8);
  if (!err) err = write_all(fd, in.hi + b, n * 8);
  for (int64_t s = b; !err && s < e; s += kChunk) {
    const int64_t m = std::min(kChunk, e - s);
    const uint32_t* out;
    if (in.count_bytes == 4) {
      out = static_cast<const uint32_t*>(in.counts) + s;
      for (int64_t i = 0; i < m; ++i) tally(t, out[i]);
    } else {
      const uint64_t* src = static_cast<const uint64_t*>(in.counts) + s;
      for (int64_t i = 0; i < m; ++i) {
        cbuf[i] = static_cast<uint32_t>(src[i]);
        tally(t, cbuf[i]);
      }
      out = cbuf.data();
    }
    err = write_all(fd, out, static_cast<size_t>(m) * 4);
  }
  for (int64_t s = b; in.labels && !err && s < e; s += kChunk) {
    const int64_t m = std::min(kChunk, e - s);
    const uint64_t* src = in.labels + s;
    uint8_t* dst = lbuf.data();
    for (int64_t i = 0; i < m; ++i) {
      const uint64_t v = src[i] & in.label_mask;
      std::memcpy(dst + i * in.label_bytes, &v, in.label_bytes);  // LE
    }
    err = write_all(fd, dst, static_cast<size_t>(m) * in.label_bytes);
  }
  return err;
}

// Entries [b, e) to the file of bucket ff -> 0 or errno.
int write_bucket(const Input& in, int ff, int64_t b, int64_t e, Tally& t,
                 std::vector<uint32_t>& cbuf, std::vector<uint8_t>& lbuf) {
  char name[16];
  std::snprintf(name, sizeof name, "/0x%02x.kmb", ff);
  const std::string path = std::string(in.dir) + name;
  const int fd = ::open(path.c_str(), O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC,
                        0666);
  if (fd < 0) return errno;
  int err;
  try {
    err = write_entries(fd, in, b, e, t, cbuf, lbuf);
  } catch (const std::bad_alloc&) {  // the histogram's overflow list
    err = ENOMEM;
  }
  if (::close(fd) != 0 && !err) err = errno;
  return err;
}

// Writes the files of `in` (every entry to file ff, or all 64 files when
// ff < 0) from `threads` threads, and tallies their counts into `res`.
void write_db(const Input& in, int64_t ff, int64_t n, int32_t threads,
              Result& res) {
  // bounds[j], bounds[j + 1]: the entries of files[j]
  std::vector<int64_t> bounds{0, n};
  std::vector<int> files{static_cast<int>(ff)};
  if (ff < 0) {
    bounds.assign(kFiles + 1, n);
    bounds[0] = 0;
    files.resize(kFiles);
    for (int f = 0; f < kFiles; ++f) files[f] = f;
    for (int f = 1; f < kFiles; ++f) {  // first entry of prefix >= f
      int64_t a = bounds[f - 1], z = n;
      while (a < z) {
        const int64_t mid = a + (z - a) / 2;
        if (static_cast<int>(prefix6(in.hi[mid], in.lo[mid], in.k)) < f)
          a = mid + 1;
        else
          z = mid;
      }
      bounds[f] = a;
    }
  }
  const int nf = static_cast<int>(files.size());
  std::vector<int> order(nf);  // the largest file first
  for (int i = 0; i < nf; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return bounds[a + 1] - bounds[a] > bounds[b + 1] - bounds[b];
  });

  const int nt = std::max(1, std::min<int>(threads, nf));
  std::vector<Tally> tallies(nt);
  std::atomic<int> next{0};
  std::mutex mu;
  auto fail = [&](int err, int file) {
    std::lock_guard<std::mutex> g(mu);
    if (!res.err) {
      res.err = static_cast<uint64_t>(err);
      res.failed = static_cast<uint64_t>(file);
    }
    next.store(nf);  // claim nothing more
  };
  auto work = [&](int w) {
    int file = kFiles;
    try {
      std::vector<uint32_t> cbuf(in.count_bytes == 4 ? 0 : kChunk);
      std::vector<uint8_t> lbuf(in.labels ? kChunk * in.label_bytes : 0);
      for (int i; (i = next.fetch_add(1)) < nf;) {
        const int j = order[i];
        file = files[j];
        const int err = write_bucket(in, file, bounds[j], bounds[j + 1],
                                     tallies[w], cbuf, lbuf);
        if (err) fail(err, file);
      }
    } catch (const std::bad_alloc&) {
      fail(ENOMEM, file);
    }
  };
  std::vector<std::thread> pool;
  try {
    for (int w = 1; w < nt; ++w) pool.emplace_back(work, w);
  } catch (const std::system_error&) {
    // fewer threads: those running claim every file
  }
  work(0);
  for (auto& th : pool) th.join();

  // the histogram: dense values ascending, then the sorted overflow
  std::vector<uint64_t>& dense = tallies[0].dense;
  std::vector<uint32_t> over;
  for (const Tally& t : tallies) {
    res.n_total += t.total;
    if (&t != &tallies[0])
      for (uint32_t v = 0; v < kDense; ++v) dense[v] += t.dense[v];
    over.insert(over.end(), t.over.begin(), t.over.end());
  }
  res.n_unique = dense[1];
  for (uint32_t v = 0; v < kDense; ++v) {
    if (dense[v]) {
      res.vals.push_back(v);
      res.occ.push_back(dense[v]);
    }
  }
  std::sort(over.begin(), over.end());
  for (size_t i = 0; i < over.size();) {
    size_t j = i;
    while (j < over.size() && over[j] == over[i]) ++j;
    res.vals.push_back(over[i]);
    res.occ.push_back(j - i);
    i = j;
  }
}

}  // namespace

// -> a handle (null only when it cannot be allocated).
extern "C" void* mt_db_write(const char* dir, int64_t ff, int64_t n,
                             const uint64_t* hi, const uint64_t* lo,
                             const void* counts, int32_t count_bytes,
                             const uint64_t* labels, uint64_t label_mask,
                             int32_t label_bytes, int32_t k, uint32_t flags,
                             int32_t threads) {
  const Input in{dir,         hi,     lo,         counts,
                 count_bytes, labels, label_mask, label_bytes,
                 static_cast<uint32_t>(k), flags};
  auto* res = new (std::nothrow) Result;
  if (res == nullptr) return nullptr;
  try {
    write_db(in, ff, n, threads, *res);
  } catch (const std::bad_alloc&) {
    if (!res->err) {
      res->err = ENOMEM;
      res->failed = kFiles;
    }
  }
  return res;
}

// info: errno (0 if every file was written), the failed file (64: none in
// particular), numUnique, numTotal, the histogram's length.
extern "C" void mt_db_info(const void* h, uint64_t* info) {
  const Result* r = static_cast<const Result*>(h);
  info[0] = r->err;
  info[1] = r->failed;
  info[2] = r->n_unique;
  info[3] = r->n_total;
  info[4] = r->vals.size();
}

// Copies the histogram (ascending values, their occurrences) where vals is
// not null, then frees the handle.
extern "C" void mt_db_finish(void* h, uint64_t* vals, uint64_t* occ) {
  Result* r = static_cast<Result*>(h);
  if (vals) {
    std::copy(r->vals.begin(), r->vals.end(), vals);
    std::copy(r->occ.begin(), r->occ.end(), occ);
  }
  delete r;
}

extern "C" int32_t mt_db_dense() { return static_cast<int32_t>(kDense); }
