// K-mer extraction from the packed 2-bit wire, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel meryl_tpu/ops/extract_pallas.py
// (_kernel, launched by extract_kmers_pallas) and fuses the wire unpack
// of meryl_tpu/ops/extract.py extract_kmers_packed, which is the head of
// the counting path (ops/accum.py route_chunk_packed).
//
// What bounds it: each window start writes one or two int64 key words
// (two or four in mode "both") and one valid byte, 9-33 B, while it reads
// 0.25 B of packed codes and at most 1/16 B of exception list.  At the
// production chunk (2^22 codes, k = 21) that is ~39 MB, ~0.0116 ms at
// 3.35 TB/s: the kernel is bound by its stores to device memory, and the
// design keeps everything else off that path.
//
// * One launch, nothing but the outputs in device memory.  Each CTA finds
//   the exceptions of its tile (halo included) in the sorted exception
//   list by a THREADS-way search (__syncthreads_count over THREADS
//   probes a step: two steps at the L/64 floor of 2^16 entries) and ORs
//   them into a tile bitmap in shared memory.  Entries >= L (the
//   INT32_MAX padding) fall out.  A later tile of the CTA carries the
//   index on by counting, without searching again.
// * O(1) work per window, no serial chain.  The wire holds base p at bits
//   2(p mod 16) of word p/16, so the 2k-bit span of codes [p, p+k) is a
//   funnel shift of the tile's words (one 64-bit span for k <= 32, two
//   for k <= 64).  The reverse complement is the span XOR 0xAAAA...
//   (complement is c ^ 2; the first base is already the least
//   significant), masked to 2k bits.  The forward key is the span with
//   its 2-bit groups reversed (__brevll, then swap the two bits of each
//   pair), shifted down by 64 - 2k.  Validity is "the k bitmap bits from
//   p are all zero and p + k <= n_real", again a funnel shift and a mask.
// * Wide, coalesced stores: for k <= 32 a thread stores two consecutive
//   keys with one 16-byte store (a warp writes 512 contiguous bytes) and
//   their two valid bytes with one 2-byte store; for k <= 64 one key of
//   two words is one 16-byte store.
// * One wave, one tile a CTA.  The grid is as many CTAs as the card
//   holds at once (occupancy x SMs), or one per MIN_RUN windows of a
//   short input, and each CTA takes an equal contiguous run of windows
//   (to 16): no CTA waits on a last, nearly empty wave.  TILE covers a
//   CTA's whole run at 2^22 codes (~4-8 K windows), so the CTA pays one
//   load round trip, and its words travel by cp.async while it searches.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): ~6.5 us a launch
// of fixed cost (launch, the search's two dependent loads, the exception
// load, the tail) plus stores streaming at ~3.1 TB/s.  Loading a second tile's
// input into registers ahead (32 -> 57 registers, half the CTAs an SM)
// lost; a persistent grid of several tiles a CTA lost to one tile a CTA.
// No TMA and no wgmma: nothing here is a matrix product, and a tile's
// input is ~2 KB.
//
// Layout (meryl_tpu_torch/ops/multiword.py): k <= 32 writes one word per
// position, k <= 64 writes [hi, lo]; every word has bit 63 flipped so that
// signed int64 order is the unsigned k-mer order.  Keys at invalid
// positions are unspecified.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 8192;                          // windows per tile
constexpr int MIN_RUN = 512;                        // windows a CTA takes
                                                    // at least
constexpr int HALO = 64;                            // codes a window reads
                                                    // past its tile (k <= 64)
constexpr int TILE_WORDS = (TILE + HALO) / 16;      // a tile's words and
constexpr int TILE_BITS = (TILE + HALO) / 32;       // bitmap, halo included
constexpr uint64_t FLIP = 1ull << 63;
constexpr uint64_t ODD = 0x5555555555555555ull;     // low bit of each pair
constexpr uint64_t COMP = 0xAAAAAAAAAAAAAAAAull;    // high bit of each pair

// One 4-byte copy from device to shared memory, in flight until
// cp.async.wait_all.
__device__ __forceinline__ void copy_async(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// 64 bits of a bit string held in 32-bit words, from bit s of w[0]
// (0 <= s < 32): w[0..2] hold them.
__device__ __forceinline__ uint64_t bits64(const uint32_t* w, int s) {
  const uint32_t a = w[0], b = w[1], c = w[2];
  return (uint64_t)__funnelshift_r(b, c, s) << 32 | __funnelshift_r(a, b, s);
}

// The 32 2-bit groups of x in reverse order.
__device__ __forceinline__ uint64_t rev_pairs(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & ODD) | ((x & ODD) << 1);
}

// NW: int64 words per key (1: k <= 32, 2: k <= 64).
// MODE: 0 canonical, 1 forward, 2 reverse, 3 both.
template <int NW, int MODE>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const uint32_t* __restrict__ packed,
               const int32_t* __restrict__ exc, int64_t n_exc, int64_t L,
               int64_t n_real, int k, int64_t* __restrict__ out0,
               int64_t* __restrict__ out1, uint8_t* __restrict__ valid) {
  constexpr int PER = NW == 1 ? 2 : 1;  // windows a 16-byte store holds
  __shared__ uint32_t words[TILE_WORDS];
  __shared__ uint32_t bits[TILE_BITS];

  // this CTA's run of windows: [start, stop), multiples of 16
  const int64_t n_words = L / 16;
  const int64_t start = n_words * blockIdx.x / gridDim.x * 16;
  const int64_t stop = n_words * (blockIdx.x + 1) / gridDim.x * 16;

  // a tile's words go to shared memory by cp.async (waited for before
  // the barrier ahead of the windows), the first tile's while the CTA
  // searches the exception list
  auto copy_words = [&](int64_t b) {
    for (int i = threadIdx.x; i < TILE_WORDS; i += THREADS) {
      const int64_t w = b / 16 + i;
      if (w < n_words) copy_async(&words[i], packed + w);
      else words[i] = 0u;
    }
  };
  copy_words(start);

  // ex = the first exception at or past start (exc is sorted ascending)
  int64_t ex = 0, hi = n_exc;
  while (ex < hi) {  // uniform: every thread sees the same counts
    const int64_t step = (hi - ex + THREADS - 1) / THREADS;
    const int64_t i = ex + threadIdx.x * step;
    const int c = __syncthreads_count(i < hi && exc[i] < start);
    if (c == 0) {
      hi = ex;
    } else {
      hi = min(ex + c * step, hi);
      ex += (int64_t)(c - 1) * step + 1;
    }
  }

  const int twok = 2 * k;
  const uint64_t kmask = k == 64 ? ~0ull : (1ull << k) - 1;
  const uint64_t mask_lo =
      (NW == 2 || twok == 64) ? ~0ull : ((1ull << twok) - 1);
  const uint64_t mask_hi =
      (NW == 1 || twok == 128) ? ~0ull : ((1ull << (twok - 64)) - 1);
  const int down = NW == 1 ? 64 - twok : 128 - twok;  // in [0, 64)

  for (int64_t base = start; base < stop; base += TILE) {
    const int n_here = (int)min((int64_t)TILE, stop - base);
    if (base != start) {
      __syncthreads();  // the previous tile is done with words[] and bits[]
      copy_words(base);
    }
    for (int i = threadIdx.x; i < TILE_BITS; i += THREADS) bits[i] = 0u;
    __syncthreads();
    // mark the exceptions in [base, base + n_here + HALO); count those
    // below base + n_here to find the next tile's first one
    const int64_t end = min(base + n_here + HALO, L);
    for (int64_t j0 = ex;; j0 += THREADS) {
      const int64_t j = j0 + threadIdx.x;
      const int64_t e = j < n_exc ? (int64_t)exc[j] : INT64_MAX;
      if (e < end) {
        const int off = (int)(e - base);
        atomicOr(&bits[off >> 5], 1u << (off & 31));
      }
      ex += __syncthreads_count(e < base + n_here);
      if (__syncthreads_count(e < end) < THREADS) break;
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    for (int j0 = threadIdx.x * PER; j0 < n_here; j0 += THREADS * PER) {
      uint64_t key[PER][2 * NW];  // [forward hi, lo][reverse hi, lo]
      uint8_t ok[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = j0 + q;
        const uint32_t* w = words + (j >> 4);
        const int s = (j & 15) * 2;
        const uint64_t span_lo = bits64(w, s);  // codes j .. j+31
        uint64_t fh = 0, fl, rh = 0, rl;
        if constexpr (NW == 1) {
          fl = rev_pairs(span_lo) >> down;
          rl = (span_lo ^ COMP) & mask_lo;
        } else {
          const uint64_t span_hi = bits64(w + 2, s);  // codes j+32 .. j+63
          const uint64_t a = rev_pairs(span_lo), b = rev_pairs(span_hi);
          fh = a >> down;
          fl = down == 0 ? b : (b >> down) | (a << (64 - down));
          rl = span_lo ^ COMP;
          rh = (span_hi ^ COMP) & mask_hi;
        }
        const uint64_t gap = bits64(bits + (j >> 5), j & 31) & kmask;
        ok[q] = gap == 0 && base + j + k <= n_real;
        bool rev = MODE == 2;
        if (MODE == 0)
          rev = NW == 1 ? rl < fl : (rh < fh || (rh == fh && rl < fl));
        uint64_t* o = key[q];
        if (MODE == 3) {
          o[0] = fh; o[NW - 1] = fl; o[NW] = rh; o[2 * NW - 1] = rl;
        } else {
          o[0] = rev ? rh : fh;
          o[NW - 1] = rev ? rl : fl;
        }
      }
      const int64_t p = base + j0;
      ulonglong2* d0 = reinterpret_cast<ulonglong2*>(out0 + p * NW);
      if constexpr (NW == 1) {
        *d0 = make_ulonglong2(key[0][0] ^ FLIP, key[1][0] ^ FLIP);
        if constexpr (MODE == 3)
          *reinterpret_cast<ulonglong2*>(out1 + p) =
              make_ulonglong2(key[0][1] ^ FLIP, key[1][1] ^ FLIP);
        *reinterpret_cast<uint16_t*>(valid + p) =
            (uint16_t)(ok[0] | (ok[1] << 8));
      } else {
        *d0 = make_ulonglong2(key[0][0] ^ FLIP, key[0][1] ^ FLIP);
        if constexpr (MODE == 3)
          *reinterpret_cast<ulonglong2*>(out1 + 2 * p) =
              make_ulonglong2(key[0][2] ^ FLIP, key[0][3] ^ FLIP);
        valid[p] = ok[0];
      }
    }
  }
}

template <int NW, int MODE>
cudaError_t launch(const uint32_t* packed, const int32_t* exc,
                   int64_t n_exc, int64_t L, int64_t n_real, int k,
                   int64_t* out0, int64_t* out1, uint8_t* valid,
                   cudaStream_t stream) {
  // resident CTAs an SM, the same on every call; atomic, since the
  // members of a sharded count launch from threads of their own
  static std::atomic<int> per_sm_once{0};
  int per_sm = per_sm_once.load(std::memory_order_relaxed);
  cudaError_t e;
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, extract_kernel<NW, MODE>, THREADS, 0);
    if (e != cudaSuccess) return e;
    per_sm_once.store(per_sm, std::memory_order_relaxed);
  }
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t runs = (L + MIN_RUN - 1) / MIN_RUN;
  const int64_t slots = (int64_t)per_sm * sms;
  const unsigned grid = (unsigned)(runs < slots ? runs : slots);
  extract_kernel<NW, MODE><<<grid, THREADS, 0, stream>>>(
      packed, exc, n_exc, L, n_real, k, out0, out1, valid);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch_mode(int mode, const uint32_t* packed,
                        const int32_t* exc, int64_t n_exc, int64_t L,
                        int64_t n_real, int k, int64_t* out0, int64_t* out1,
                        uint8_t* valid, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<NW, 0>(packed, exc, n_exc, L, n_real, k, out0, out1, valid, s);
    case 1: return launch<NW, 1>(packed, exc, n_exc, L, n_real, k, out0, out1, valid, s);
    case 2: return launch<NW, 2>(packed, exc, n_exc, L, n_real, k, out0, out1, valid, s);
    case 3: return launch<NW, 3>(packed, exc, n_exc, L, n_real, k, out0, out1, valid, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// packed: (L/16,) uint32 words; exc: (n_exc,) int32 exception positions,
// sorted ascending (INT32_MAX padding last); out0/out1: (L, NW) int64
// (out1 only for mode 3); valid: (L,) bool.  L % 16 == 0.  One launch.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mt_extract_packed(const void* packed, const void* exc,
                                 int64_t n_exc, int64_t L, int64_t n_real,
                                 int k, int mode, void* out0, void* out1,
                                 void* valid, void* stream) {
  if (k < 1 || k > 64 || mode < 0 || mode > 3 || L % 16 != 0 || L < 0 ||
      n_exc < 0)
    return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  const int32_t* x = static_cast<const int32_t*>(exc);
  int64_t* o0 = static_cast<int64_t*>(out0);
  int64_t* o1 = static_cast<int64_t*>(out1);
  uint8_t* v = static_cast<uint8_t*>(valid);
  cudaError_t e = k <= 32
      ? launch_mode<1>(mode, p, x, n_exc, L, n_real, k, o0, o1, v, s)
      : launch_mode<2>(mode, p, x, n_exc, L, n_real, k, o0, o1, v, s);
  return (int)e;
}
