// K-mer extraction from the packed 2-bit wire, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel meryl_tpu/ops/extract_pallas.py
// (_kernel, launched by extract_kmers_pallas) and fuses the wire unpack
// of meryl_tpu/ops/extract.py extract_kmers_packed, which is the head of
// the counting path (ops/accum.py route_chunk_packed).
//
// What bounds it: each window start writes one or two int64 key words
// (two or four in mode "both") and one valid byte, 9-33 B, while it reads
// 0.25 B of packed codes and 1/8 B of exception bitmap.  It is bound by
// stores to device memory.  So the block stages its input tile in shared
// memory once, each thread rolls its keys one base per position (O(1)
// work per window instead of the Pallas kernel's O(log k) doubling
// passes), and keys are staged in shared memory so the copy-out is
// coalesced.  No TMA and no wgmma: nothing here is a matrix product.
//
// Layout (meryl_tpu_torch/ops/multiword.py): k <= 32 writes one word per
// position, k <= 64 writes [hi, lo]; every word has bit 63 flipped so that
// signed int64 order is the unsigned k-mer order.  Keys at invalid
// positions are unspecified.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int RUN = 16;                     // window starts per thread
constexpr int TILE = THREADS * RUN;         // window starts per block
constexpr int TILE_PAD = TILE + TILE / RUN; // a gap slot after each run
                                            // keeps staged stores off one
                                            // shared-memory bank
constexpr int HALO_WORDS = 4;               // ceil(63 / 16) packed words
constexpr int TILE_WORDS = TILE / 16 + HALO_WORDS;
constexpr int TILE_BITS = TILE / 32 + 3;    // bitmap words, halo included
constexpr uint64_t FLIP = 1ull << 63;

__global__ void mark_exceptions(const int32_t* __restrict__ exc,
                                int64_t n_exc, uint32_t* bitmap,
                                int64_t L) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n_exc) return;
  int64_t e = exc[i];
  if (e < 0 || e >= L) return;  // INT32_MAX padding drops here
  atomicOr(&bitmap[e >> 5], 1u << (e & 31));
}

// NW: int64 words per key (1: k <= 32, 2: k <= 64).
// MODE: 0 canonical, 1 forward, 2 reverse, 3 both.
template <int NW, int MODE>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const uint32_t* __restrict__ packed,
               const uint32_t* __restrict__ bitmap, int64_t L,
               int64_t n_real, int k, int64_t* __restrict__ out0,
               int64_t* __restrict__ out1, uint8_t* __restrict__ valid) {
  constexpr int NOUT = (MODE == 3 ? 2 : 1) * NW;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* stage = reinterpret_cast<uint64_t*>(smem);
  uint32_t* words = reinterpret_cast<uint32_t*>(stage + NOUT * TILE_PAD);
  uint32_t* bits = words + TILE_WORDS;

  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int64_t n_words = L / 16;
  const int64_t n_bits = (L + 31) / 32;
  for (int i = threadIdx.x; i < TILE_WORDS; i += THREADS) {
    int64_t w = base / 16 + i;
    words[i] = w < n_words ? packed[w] : 0u;
  }
  for (int i = threadIdx.x; i < TILE_BITS; i += THREADS) {
    int64_t w = base / 32 + i;
    bits[i] = w < n_bits ? bitmap[w] : 0xFFFFFFFFu;
  }
  __syncthreads();

  const int twok = 2 * k;
  const uint64_t mask_lo =
      (NW == 2 || twok == 64) ? ~0ull : ((1ull << twok) - 1);
  const uint64_t mask_hi =
      (NW == 1 || twok == 128) ? ~0ull : ((1ull << (twok - 64)) - 1);
  uint64_t fh = 0, fl = 0, rh = 0, rl = 0;
  int run = 0;  // consecutive valid codes ending at the last push

  auto push = [&](int off) {
    uint32_t c = (words[off >> 4] >> ((off & 15) * 2)) & 3u;
    bool bad = base + off >= L || ((bits[off >> 5] >> (off & 31)) & 1u);
    run = bad ? 0 : run + 1;
    uint64_t rc = c ^ 2u;
    if constexpr (NW == 1) {
      fl = ((fl << 2) | c) & mask_lo;
      rl = (rl >> 2) | (rc << (twok - 2));
    } else {
      fh = ((fh << 2) | (fl >> 62)) & mask_hi;
      fl = (fl << 2) | c;
      rl = (rl >> 2) | (rh << 62);
      rh = (rh >> 2) | (rc << (twok - 66));
    }
  };

  const int off0 = threadIdx.x * RUN;
  for (int j = 0; j < k - 1; ++j) push(off0 + j);

  uint32_t vw[RUN / 4] = {0, 0, 0, 0};
  for (int j = 0; j < RUN; ++j) {
    push(off0 + j + k - 1);
    const int64_t p = base + off0 + j;
    const bool ok = run >= k && p + k <= n_real;
    vw[j >> 2] |= (uint32_t)ok << ((j & 3) * 8);
    const int slot = off0 + j + threadIdx.x;  // padded position
    uint64_t kh = fh, kl = fl;  // forward unless reverse is chosen
    if (MODE == 2 || (MODE == 0 && (NW == 1 ? rl < fl
                                            : (rh < fh ||
                                               (rh == fh && rl < fl))))) {
      kh = rh;
      kl = rl;
    }
    if constexpr (NW == 2) {
      stage[0 * TILE_PAD + slot] = kh ^ FLIP;
      stage[1 * TILE_PAD + slot] = kl ^ FLIP;
    } else {
      stage[slot] = kl ^ FLIP;
    }
    if constexpr (MODE == 3) {
      if constexpr (NW == 2) {
        stage[2 * TILE_PAD + slot] = rh ^ FLIP;
        stage[3 * TILE_PAD + slot] = rl ^ FLIP;
      } else {
        stage[1 * TILE_PAD + slot] = rl ^ FLIP;
      }
    }
  }

  const int64_t p0 = base + off0;
  if (p0 + RUN <= L) {
    *reinterpret_cast<uint4*>(valid + p0) =
        make_uint4(vw[0], vw[1], vw[2], vw[3]);
  } else {
    for (int j = 0; j < RUN && p0 + j < L; ++j)
      valid[p0 + j] = (vw[j >> 2] >> ((j & 3) * 8)) & 1u;
  }
  __syncthreads();

  const int64_t n_here = L - base < TILE ? L - base : TILE;
  for (int i = threadIdx.x; i < n_here * NW; i += THREADS) {
    const int pos = i / NW, w = i % NW;
    const int slot = pos + pos / RUN;
    out0[base * NW + i] = (int64_t)stage[w * TILE_PAD + slot];
    if constexpr (MODE == 3)
      out1[base * NW + i] = (int64_t)stage[(NW + w) * TILE_PAD + slot];
  }
}

template <int NW, int MODE>
cudaError_t launch(const uint32_t* packed, const uint32_t* bitmap,
                   int64_t L, int64_t n_real, int k, int64_t* out0,
                   int64_t* out1, uint8_t* valid, cudaStream_t stream) {
  constexpr int NOUT = (MODE == 3 ? 2 : 1) * NW;
  const size_t smem = NOUT * TILE_PAD * sizeof(uint64_t) +
                      (TILE_WORDS + TILE_BITS) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      extract_kernel<NW, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((L + TILE - 1) / TILE);
  extract_kernel<NW, MODE><<<grid, THREADS, smem, stream>>>(
      packed, bitmap, L, n_real, k, out0, out1, valid);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch_mode(int mode, const uint32_t* packed,
                        const uint32_t* bitmap, int64_t L, int64_t n_real,
                        int k, int64_t* out0, int64_t* out1, uint8_t* valid,
                        cudaStream_t s) {
  switch (mode) {
    case 0: return launch<NW, 0>(packed, bitmap, L, n_real, k, out0, out1, valid, s);
    case 1: return launch<NW, 1>(packed, bitmap, L, n_real, k, out0, out1, valid, s);
    case 2: return launch<NW, 2>(packed, bitmap, L, n_real, k, out0, out1, valid, s);
    case 3: return launch<NW, 3>(packed, bitmap, L, n_real, k, out0, out1, valid, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// packed: (L/16,) uint32 words; exc: (n_exc,) int32 exception positions;
// bitmap: (ceil(L/32),) uint32, zeroed by the caller; out0/out1: (L, NW)
// int64 (out1 only for mode 3); valid: (L,) bool.  L % 16 == 0.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mt_extract_packed(const void* packed, const void* exc,
                                 int64_t n_exc, void* bitmap, int64_t L,
                                 int64_t n_real, int k, int mode,
                                 void* out0, void* out1, void* valid,
                                 void* stream) {
  if (k < 1 || k > 64 || mode < 0 || mode > 3 || L % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_exc > 0) {
    const unsigned grid = (unsigned)((n_exc + 255) / 256);
    mark_exceptions<<<grid, 256, 0, s>>>(
        static_cast<const int32_t*>(exc), n_exc,
        static_cast<uint32_t*>(bitmap), L);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (L == 0) return 0;
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  const uint32_t* b = static_cast<const uint32_t*>(bitmap);
  int64_t* o0 = static_cast<int64_t*>(out0);
  int64_t* o1 = static_cast<int64_t*>(out1);
  uint8_t* v = static_cast<uint8_t*>(valid);
  cudaError_t e = k <= 32
      ? launch_mode<1>(mode, p, b, L, n_real, k, o0, o1, v, s)
      : launch_mode<2>(mode, p, b, L, n_real, k, o0, o1, v, s);
  return (int)e;
}
