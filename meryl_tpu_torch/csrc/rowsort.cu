// Row-batched bitonic sorts in shared memory, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of scripts/probe_r4_pallas_sort.py:
//   * bitonic_kernel (the full bitonic network over 2048-element int32
//     rows held as (16, 128) VMEM tiles) -> bitonic_i32_kernel, and the
//     same network on the set-op row sort's keys -> bitonic_keys_kernel,
//     which sorts the rows of meryl_tpu/ops/setops.py _merge_sort_stage
//     (lax.sort(..., is_stable=True) with two payloads);
//   * roll_pass_kernel (66 identical stride-1 compare-exchange passes,
//     the network's depth floor) -> pass_floor_kernel.
//
// One CTA sorts one row.  The row is padded to the next power of two n
// with the largest key, held in shared memory, and sorted by the XOR-
// partner network of the probe: stage `size` = 2 .. n, sub-stage j =
// size/2 .. 1, element i pairs with i ^ j and keeps the minimum when
// bit j of i differs from the "up" bit (i & size) == 0.  Each thread
// takes pairs t = threadIdx.x, +blockDim.x, .. of the n/2 pairs, whose
// lower element is i = 2t - (t & (j - 1)).  The TPU kernel's lane and
// sublane rolls have no counterpart here: shared memory is addressed
// directly.
//
// Stability: the set-op keys carry their original column as a 16-bit
// index and ties compare on it, so the network's output is the stable
// order; the kernel then writes the sorted keys and gathers both
// payloads (values, input ids) by that index in the same launch.  Pad
// entries take the largest key AND an index >= L, so they sort after
// every real entry, including the real all-ones k-mer whose word image
// is the largest key at k = 16 and 32.
//
// What bounds it: n log2(n) (log2(n) + 1) / 4 compare-exchanges on
// shared memory with a __syncthreads after each of the log2(n)
// (log2(n) + 1) / 2 passes (91 at n = 8192); device memory is read and
// written once.  So it is bound by shared-memory traffic and barriers,
// not by HBM.  This first version does each pass in shared memory; warp
// shuffles for the strides below 32 are later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_ROW = 8192;     // = meryl_tpu_torch/ops/rowsort.py MAX_ROW
constexpr int MAX_THREADS = 1024;

template <class Row>
__device__ void bitonic_network(Row row, int n) {
  const int half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        const int p = i + j;
        const auto a = row.load(i);
        const auto b = row.load(p);
        const bool up = (i & size) == 0;
        if (up ? Row::less(b, a) : Row::less(a, b)) {
          row.store(i, b);
          row.store(p, a);
        }
      }
      __syncthreads();
    }
  }
}

struct I32Row {
  int32_t* s;
  __device__ int32_t load(int i) const { return s[i]; }
  __device__ void store(int i, int32_t v) const { s[i] = v; }
  __device__ static bool less(int32_t a, int32_t b) { return a < b; }
};

template <int NW>
struct KeyElem {
  int64_t w[NW];
  uint16_t idx;
};

template <int NW>
struct KeyRow {
  int64_t* w;      // NW planes of n words each, most significant first
  uint16_t* idx;   // original column of each entry
  int n;
  __device__ KeyElem<NW> load(int i) const {
    KeyElem<NW> e;
#pragma unroll
    for (int q = 0; q < NW; ++q) e.w[q] = w[q * n + i];
    e.idx = idx[i];
    return e;
  }
  __device__ void store(int i, const KeyElem<NW>& e) const {
#pragma unroll
    for (int q = 0; q < NW; ++q) w[q * n + i] = e.w[q];
    idx[i] = e.idx;
  }
  __device__ static bool less(const KeyElem<NW>& a, const KeyElem<NW>& b) {
#pragma unroll
    for (int q = 0; q < NW; ++q)
      if (a.w[q] != b.w[q]) return a.w[q] < b.w[q];
    return a.idx < b.idx;
  }
};

__global__ void __launch_bounds__(MAX_THREADS)
bitonic_i32_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   int L, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s = reinterpret_cast<int32_t*>(smem);
  const int64_t base = (int64_t)blockIdx.x * L;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = i < L ? x[base + i] : INT32_MAX;
  __syncthreads();
  bitonic_network(I32Row{s}, n);
  for (int i = threadIdx.x; i < L; i += blockDim.x) out[base + i] = s[i];
}

template <int NW>
__global__ void __launch_bounds__(MAX_THREADS)
bitonic_keys_kernel(const int64_t* __restrict__ key,
                    const int64_t* __restrict__ val,
                    const int32_t* __restrict__ ids,
                    int64_t* __restrict__ okey, int64_t* __restrict__ oval,
                    int32_t* __restrict__ oids, int L, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  KeyRow<NW> row;
  row.w = reinterpret_cast<int64_t*>(smem);
  row.idx = reinterpret_cast<uint16_t*>(row.w + NW * n);
  row.n = n;
  const int64_t base = (int64_t)blockIdx.x * L;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int q = 0; q < NW; ++q)
      row.w[q * n + i] = i < L ? key[(base + i) * NW + q] : INT64_MAX;
    row.idx[i] = (uint16_t)i;
  }
  __syncthreads();
  bitonic_network(row, n);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
#pragma unroll
    for (int q = 0; q < NW; ++q) okey[(base + i) * NW + q] = row.w[q * n + i];
    const int64_t src = base + row.idx[i];
    oval[base + i] = val[src];
    oids[base + i] = ids[src];
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
pass_floor_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  int L, int passes) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s = reinterpret_cast<int32_t*>(smem);
  const int64_t base = (int64_t)blockIdx.x * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) s[i] = x[base + i];
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    for (int t = threadIdx.x; t < L / 2; t += blockDim.x) {
      const int32_t a = s[2 * t], b = s[2 * t + 1];
      s[2 * t] = a < b ? a : b;
      s[2 * t + 1] = a < b ? b : a;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) out[base + i] = s[i];
}

int next_pow2(int L) {
  int n = 1;
  while (n < L) n <<= 1;
  return n;
}

int threads_for(int pairs) {
  int t = 32;
  while (t < pairs && t < MAX_THREADS) t <<= 1;
  return t;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NW>
cudaError_t launch_keys(const int64_t* key, const int64_t* val,
                        const int32_t* ids, int64_t* okey, int64_t* oval,
                        int32_t* oids, int64_t R, int L, cudaStream_t s) {
  const int n = next_pow2(L);
  const size_t smem = (size_t)n * (NW * sizeof(int64_t) + sizeof(uint16_t));
  cudaError_t e = allow_smem(bitonic_keys_kernel<NW>, smem);
  if (e != cudaSuccess) return e;
  bitonic_keys_kernel<NW><<<(unsigned)R, threads_for(n / 2), smem, s>>>(
      key, val, ids, okey, oval, oids, L, n);
  return cudaGetLastError();
}

}  // namespace

// x, out: (R, L) int32, row-major.  Each row of out = row of x sorted.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mt_bitonic_i32(const void* x, void* out, int64_t R, int L,
                              void* stream) {
  if (R < 0 || L < 0 || L > MAX_ROW || R > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return 0;
  const int n = next_pow2(L);
  const size_t smem = (size_t)n * sizeof(int32_t);
  cudaError_t e = allow_smem(bitonic_i32_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  bitonic_i32_kernel<<<(unsigned)R, threads_for(n / 2), smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), L, n);
  return (int)cudaGetLastError();
}

// key/okey: (R, L, nw) int64 words (nw = 1 or 2, most significant
// first); val/oval: (R, L) int64; ids/oids: (R, L) int32.  Each row is
// sorted stably by key; the payloads follow their keys.
extern "C" int mt_bitonic_keys(const void* key, const void* val,
                               const void* ids, void* okey, void* oval,
                               void* oids, int64_t R, int L, int nw,
                               void* stream) {
  if (R < 0 || L < 0 || L > MAX_ROW || R > INT_MAX || (nw != 1 && nw != 2))
    return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(key);
  const int64_t* v = static_cast<const int64_t*>(val);
  const int32_t* d = static_cast<const int32_t*>(ids);
  int64_t* ok = static_cast<int64_t*>(okey);
  int64_t* ov = static_cast<int64_t*>(oval);
  int32_t* od = static_cast<int32_t*>(oids);
  cudaError_t e = nw == 1 ? launch_keys<1>(k, v, d, ok, ov, od, R, L, s)
                          : launch_keys<2>(k, v, d, ok, ov, od, R, L, s);
  return (int)e;
}

// x, out: (R, L) int32.  `passes` stride-1 compare-exchange passes over
// each row's (even, odd) pairs in shared memory.
extern "C" int mt_pass_floor(const void* x, void* out, int64_t R, int L,
                             int passes, void* stream) {
  if (R < 0 || L < 0 || L > MAX_ROW || R > INT_MAX || passes < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return 0;
  const size_t smem = (size_t)L * sizeof(int32_t);
  cudaError_t e = allow_smem(pass_floor_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  pass_floor_kernel<<<(unsigned)R, threads_for(L / 2), smem,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), L, passes);
  return (int)cudaGetLastError();
}
