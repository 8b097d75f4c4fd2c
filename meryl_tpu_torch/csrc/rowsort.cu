// Row-batched bitonic sorts for Hopper (sm_90a): registers first, warp
// shuffles for the middle strides, shared memory only to change layout.
//
// Replaces the two Pallas TPU kernels of scripts/probe_r4_pallas_sort.py:
//   * bitonic_kernel (the full bitonic network over 2048-element int32
//     rows held as (16, 128) VMEM tiles) -> bitonic_i32_kernel, and the
//     same network on the set-op row sort's keys -> bitonic_keys_kernel,
//     which sorts the rows of meryl_tpu/ops/setops.py _merge_sort_stage
//     (lax.sort(..., is_stable=True) with two payloads);
//   * roll_pass_kernel (66 identical stride-1 compare-exchange passes,
//     the network's depth floor) -> pass_floor_flat and pass_floor_rows,
//     registers only (their note is at "the pass floor" below).
//
// The network.  One CTA sorts one row of L <= MAX_ROW entries with the
// all-ascending bitonic network on n = next_pow2(L) positions: stage
// size = 2 .. n first compares position i with its mirror i ^ (size - 1),
// then each sub-stage j = size/4 .. 1 compares i with i ^ j; the lower
// position always keeps the smaller element.  No block ever sorts
// downwards, so the positions >= L behave as +inf that never move, and a
// compare-exchange whose upper partner is >= L changes nothing.  Pad
// slots are neither loaded nor stored, no warp holding only pads is
// launched, and the shared-memory phase skips every group of positions
// that holds only pads.  Inside a warp a pad slot holds the virtual +inf
// in a register (the largest key with its own position as the column),
// so its compare-exchanges are exact no-ops.
//
// The layout.  The CTA has ceil(L / E) threads rounded up to whole warps;
// thread t holds positions t*E .. t*E + E - 1 in registers (E = 16).
//   * strides j < E stay inside the thread: fully unrolled compare-
//     exchanges, no memory, no barrier;
//   * E <= j < W = 32 * E: the partner is lane ^ (j / E) of the same warp
//     (for the mirror, lane ^ (size / E - 1) and register E - 1 - e),
//     reached by __shfl_xor_sync; each lane keeps the min or the max by
//     which of the two positions is lower.  No barrier;
//   * a stage above W has a cross-warp head: the mirror and j = size/4
//     .. W.  The CTA stores its registers to shared memory (barrier),
//     each thread loads a coset of 2^C positions closed under those
//     strides (C = log2(size / W) <= 4: x, x + W, .. in the stage block's
//     lower half and their mirrors in the upper half), runs the head in
//     registers and stores back (barrier), and the CTA reloads its
//     registers for the strides below W.  Two barriers a stage above W,
//     not one a pass: 8 at L = 3072 and 6 at L = 2048, loads and stores
//     included, against the old design's 78 and 66.
//
// Stability: a set-op key carries its original column as a 32-bit
// register (`idx`) and ties compare on it, so every key is distinct and
// the network's order is the stable one; the kernel then writes the
// sorted keys and gathers both payloads (values, input ids) by that
// index in the same launch.  Virtual pads never meet a real key, so the
// real all-ones k-mer, whose word image equals the largest key at k = 16
// and 32, keeps its stable place.
//
// Memory.  A row is read and written once: 16-byte vector loads, striped
// over the CTA (coalesced), into a padded shared-memory stage, and the
// sorted row leaves the same way in 16-byte stores.  The stage keeps one
// spare slot per 128 bytes, so a thread's E consecutive slots meet no
// bank conflict, 8-byte words included (the striped copies, once a row,
// meet two- to four-way conflicts).
//
// What bounds it: about n log2(n) (log2(n) + 1) / 4 compare-exchanges,
// each a few integer instructions in registers (or a shuffle of 1, 3 or 5
// 32-bit words and a select), plus log2(n / W) shared-memory round trips
// of the row; HBM traffic is the row once in and once out.  On the card
// the network, not memory, takes most of the time: for 512 set-op rows
// of 3072 at k = 21 the copies and the payload gather alone take about a
// quarter of the kernel; the rest is compare-exchanges and shuffles,
// whose latency only more warps an SM hide (hence the register cap on
// bitonic_keys_kernel).  The first version of this file ran every pass
// in shared memory with a __syncthreads after each and padded each row
// to n in memory and in work; on an NVIDIA H100 80GB HBM3 at 700 W it
// took 0.8189 ms for 2^13 x 2048 int32 rows (torch.sort 0.5682 ms) and
// 0.1852 ms for the set-op path's 512 x 3072 rows at k = 21 (plain
// stable sort 0.1607 ms).

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_ROW = 8192;     // = meryl_tpu_torch/ops/rowsort.py MAX_ROW
constexpr int E = 16;             // positions a thread holds in registers
constexpr int WARP = 32;
constexpr int W = WARP * E;       // positions a warp holds
constexpr int MAX_THREADS = MAX_ROW / E;
constexpr int FLOOR_THREADS = 256;  // a CTA of the pass floor
constexpr int FLOOR_QUADS = 4;      // 16-byte quads a pass-floor thread holds
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_ROW / W <= 16, "a cross-warp coset holds at most 16");

// ------------------------------------------------------------ elements

struct I32 {                      // a probe row entry: the value is the key
  int32_t k;
  __device__ static I32 pad(int) { return {INT32_MAX}; }
  __device__ static bool less(const I32& a, const I32& b) { return a.k < b.k; }
  __device__ I32 shfl_xor(int m) const {
    return {__shfl_xor_sync(FULL, k, m)};
  }
};

template <int NW>
struct Key {                      // a set-op entry: NW words, then column
  int64_t w[NW];                  // most significant first
  int32_t idx;
  __device__ static Key pad(int pos) {
    Key e;
#pragma unroll
    for (int q = 0; q < NW; ++q) e.w[q] = INT64_MAX;
    e.idx = pos;
    return e;
  }
  __device__ static bool less(const Key& a, const Key& b) {
    bool lt = a.idx < b.idx;
#pragma unroll
    for (int q = NW - 1; q >= 0; --q)
      lt = a.w[q] < b.w[q] || (a.w[q] == b.w[q] && lt);
    return lt;
  }
  __device__ Key shfl_xor(int m) const {
    Key e;
#pragma unroll
    for (int q = 0; q < NW; ++q)
      e.w[q] = (int64_t)__shfl_xor_sync(FULL, (long long)w[q], m);
    e.idx = __shfl_xor_sync(FULL, idx, m);
    return e;
  }
};

// a <- the smaller, b <- the larger
template <class T>
__device__ __forceinline__ void cex(T& a, T& b) {
  const bool sw = T::less(b, a);
  const T lo = sw ? b : a;
  const T hi = sw ? a : b;
  a = lo;
  b = hi;
}

__device__ __forceinline__ void cex(I32& a, I32& b) {
  const int32_t lo = min(a.k, b.k), hi = max(a.k, b.k);
  a.k = lo;
  b.k = hi;
}

// What a lane keeps of the pair (mine, its partner's): the smaller if
// its position is the lower one, else the larger.
template <class T>
__device__ __forceinline__ T keep(const T& mine, const T& other, bool lower) {
  return T::less(other, mine) == lower ? other : mine;
}

// ------------------------------------------- strides inside the thread

template <int J, class T>
__device__ __forceinline__ void reg_step(T (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (!(e & J)) cex(v[e], v[e | J]);
}

// sub-stages j, j/2, .., 1 of those below E
template <int J, class T>
__device__ __forceinline__ void reg_down(T (&v)[E], int j) {
  if constexpr (J >= 1) {
    if (j >= J) reg_step<J>(v);
    reg_down<J / 2>(v, j);
  }
}

// the mirror of a stage of size S <= E
template <int S, class T>
__device__ __forceinline__ void reg_mirror(T (&v)[E], int size) {
  if constexpr (S >= 2) {
    if (size == S) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & (S / 2))) cex(v[e], v[e ^ (S - 1)]);
      return;
    }
    reg_mirror<S / 2>(v, size);
  }
}

// -------------------------------------------- strides across the warp

// j = m * E: the partner is lane ^ m, the same register
template <class T>
__device__ __forceinline__ void shfl_step(T (&v)[E], int m, int lane) {
  const bool lower = !(lane & m);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = keep(v[e], v[e].shfl_xor(m), lower);
}

// the mirror of a stage E < size <= W: the partner of register e is
// register E - 1 - e of lane ^ m, m = size / E - 1.  Both shuffles of a
// register pair go before either register changes.
template <class T>
__device__ __forceinline__ void shfl_mirror(T (&v)[E], int m, int lane) {
  const bool lower = !(lane & ((m + 1) >> 1));
#pragma unroll
  for (int e = 0; e < E / 2; ++e) {
    const T a = v[E - 1 - e].shfl_xor(m);   // pairs with my e
    const T b = v[e].shfl_xor(m);           // pairs with my E - 1 - e
    v[e] = keep(v[e], a, lower);
    v[E - 1 - e] = keep(v[E - 1 - e], b, lower);
  }
}

// sub-stages j, j/2, .., 1 with j < W
template <class T>
__device__ __forceinline__ void warp_down(T (&v)[E], int j, int lane) {
  for (; j >= E; j >>= 1) shfl_step(v, j / E, lane);
  reg_down<E / 2>(v, j);
}

// ------------------------------------------------------- shared memory

// One spare slot per 128 bytes: a thread's E consecutive slots, and the
// striped copies, meet no bank conflict.
__host__ __device__ constexpr int pad4(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int pad8(int i) { return i + (i >> 4); }
// slots of a padded plane of L entries, rounded to 16 bytes
__host__ __device__ constexpr int cap4(int L) { return (pad4(L) + 4) & ~3; }
__host__ __device__ constexpr int cap8(int L) { return (pad8(L) + 2) & ~1; }

struct I32Stage {
  int32_t* s;
  __device__ I32 load(int i) const { return {s[pad4(i)]}; }
  __device__ void store(int i, const I32& e) const { s[pad4(i)] = e.k; }
};

template <int NW>
struct KeyStage {
  int64_t* w;     // NW planes of `cap` slots
  int32_t* idx;   // the column of each position
  int cap;
  __device__ int64_t& word(int f) const {   // word f of the flat key row
    return w[(f % NW) * cap + pad8(f / NW)];
  }
  __device__ Key<NW> load(int i) const {
    Key<NW> e;
#pragma unroll
    for (int q = 0; q < NW; ++q) e.w[q] = w[q * cap + pad8(i)];
    e.idx = idx[pad4(i)];
    return e;
  }
  __device__ void store(int i, const Key<NW>& e) const {
#pragma unroll
    for (int q = 0; q < NW; ++q) w[q * cap + pad8(i)] = e.w[q];
    idx[pad4(i)] = e.idx;
  }
};

template <class T, class S>
__device__ __forceinline__ void load_regs(T (&v)[E], const S& s, int L) {
  const int p0 = threadIdx.x * E;
#pragma unroll
  for (int e = 0; e < E; ++e)
    v[e] = p0 + e < L ? s.load(p0 + e) : T::pad(p0 + e);
}

template <class T, class S>
__device__ __forceinline__ void store_regs(const T (&v)[E], const S& s,
                                           int L) {
  const int p0 = threadIdx.x * E;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (p0 + e < L) s.store(p0 + e, v[e]);
}

// The cross-warp head of stage `size` = W << C, in shared memory.  Coset
// (b, x), x < W, is the positions b + x + u W (u < 2^(C-1)) of the stage
// block at b and their mirrors b + size - 1 - x - u W: closed under the
// mirror and under j = size/4 .. W, which flip bits of u.  In the upper
// half the positions fall as u grows, so there the smaller goes to the
// larger u.
template <int C, class T, class S>
__device__ void cross_warp(const S& s, int size, int L) {
  constexpr int M = 1 << C, H = M / 2;
  const int cosets = (L + size - 1) / size * W;
  for (int c = threadIdx.x; c < cosets; c += blockDim.x) {
    const int b = c / W * size, x = c % W;
    if (b + x >= L) continue;               // only pads
    int pos[M];
    T r[M];
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const int o = x + (u % H) * W;
      pos[u] = b + (u < H ? o : size - 1 - o);
      r[u] = pos[u] < L ? s.load(pos[u]) : T::pad(pos[u]);
    }
#pragma unroll
    for (int u = 0; u < H; ++u) cex(r[u], r[u + H]);       // the mirror
#pragma unroll
    for (int q = C - 2; q >= 0; --q)                       // j = W << q
#pragma unroll
      for (int u = 0; u < M; ++u)
        if (!(u & (1 << q))) {
          if (u < H)
            cex(r[u], r[u | (1 << q)]);
          else
            cex(r[u | (1 << q)], r[u]);
        }
#pragma unroll
    for (int u = 0; u < M; ++u)
      if (pos[u] < L) s.store(pos[u], r[u]);
  }
}

// The network on a row whose positions < L the CTA's registers hold
// (blocked, E a thread); `s` is the row's shared-memory stage.
template <class T, class S>
__device__ void sort_row(T (&v)[E], const S& s, int L) {
  const int lane = threadIdx.x & (WARP - 1);
  int n = 1;
  while (n < L) n <<= 1;
  for (int size = 2; size <= n; size <<= 1) {
    int j = size >> 2;
    if (size <= W) {
      if (size > E)
        shfl_mirror(v, size / E - 1, lane);
      else
        reg_mirror<E>(v, size);
    } else {
      store_regs(v, s, L);
      __syncthreads();
      switch (size / W) {
        case 2: cross_warp<1, T>(s, size, L); break;
        case 4: cross_warp<2, T>(s, size, L); break;
        case 8: cross_warp<3, T>(s, size, L); break;
        default: cross_warp<4, T>(s, size, L); break;
      }
      __syncthreads();
      load_regs(v, s, L);
      j = W >> 1;
    }
    warp_down(v, j, threadIdx.x & (WARP - 1));
  }
}

// ------------------------------------------------------- device memory

// put(i, g[i]) for i < cnt, striped over the CTA, 16-byte loads for the
// aligned middle (g is aligned to sizeof(T)).
template <class T, class F>
__device__ __forceinline__ void copy_in(const T* __restrict__ g, int cnt,
                                        F put) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(cnt, (int)(((16 - (reinterpret_cast<uintptr_t>(g) &
                                          15)) & 15) / sizeof(T)));
  const int nv = (cnt - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) put(i, g[i]);
  const int4* gv = reinterpret_cast<const int4*>(g + head);
  for (int q = threadIdx.x; q < nv; q += blockDim.x) {
    const int4 x = gv[q];
    T t[V];
    memcpy(t, &x, sizeof(x));
#pragma unroll
    for (int u = 0; u < V; ++u) put(head + q * V + u, t[u]);
  }
  for (int i = head + nv * V + threadIdx.x; i < cnt; i += blockDim.x)
    put(i, g[i]);
}

// g[i] = get(i) for i < cnt, the same way
template <class T, class F>
__device__ __forceinline__ void copy_out(T* __restrict__ g, int cnt, F get) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(cnt, (int)(((16 - (reinterpret_cast<uintptr_t>(g) &
                                          15)) & 15) / sizeof(T)));
  const int nv = (cnt - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) g[i] = get(i);
  int4* gv = reinterpret_cast<int4*>(g + head);
  for (int q = threadIdx.x; q < nv; q += blockDim.x) {
    T t[V];
#pragma unroll
    for (int u = 0; u < V; ++u) t[u] = get(head + q * V + u);
    int4 x;
    memcpy(&x, t, sizeof(x));
    gv[q] = x;
  }
  for (int i = head + nv * V + threadIdx.x; i < cnt; i += blockDim.x)
    g[i] = get(i);
}

// ------------------------------------------------------------- kernels

__global__ void __launch_bounds__(MAX_THREADS)
bitonic_i32_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const I32Stage s{reinterpret_cast<int32_t*>(smem)};
  const int64_t base = (int64_t)blockIdx.x * L;
  copy_in(x + base, L, [&](int i, int32_t a) { s.s[pad4(i)] = a; });
  __syncthreads();
  I32 v[E];
  load_regs(v, s, L);
  sort_row(v, s, L);
  store_regs(v, s, L);
  __syncthreads();
  copy_out(out + base, L, [&](int i) { return s.s[pad4(i)]; });
}

// Registers bound the CTAs an SM holds, and so whether the set-op path's
// ~500 rows fill the card in one wave.  Left alone the compiler gives
// one-word keys 97 registers (a 7-warp CTA for L ~ 3172 then fits twice
// an SM); capped at 72 it fits four, with a few bytes of spill.  Two-word
// keys keep 128: any cap spills them hard.
template <int NW>
__global__ void __maxnreg__(NW == 1 ? 72 : 128)
bitonic_keys_kernel(const int64_t* __restrict__ key,
                    const int64_t* __restrict__ val,
                    const int32_t* __restrict__ ids,
                    int64_t* __restrict__ okey, int64_t* __restrict__ oval,
                    int32_t* __restrict__ oids, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = cap8(L);
  const KeyStage<NW> s{reinterpret_cast<int64_t*>(smem),
                       reinterpret_cast<int32_t*>(smem) + 2 * NW * cap, cap};
  const int64_t base = (int64_t)blockIdx.x * L;
  copy_in(key + base * NW, L * NW,
          [&](int f, int64_t a) { s.word(f) = a; });
  for (int i = threadIdx.x; i < L; i += blockDim.x) s.idx[pad4(i)] = i;
  __syncthreads();
  Key<NW> v[E];
  load_regs(v, s, L);
  sort_row(v, s, L);
  store_regs(v, s, L);
  __syncthreads();
  copy_out(okey + base * NW, L * NW, [&](int f) { return s.word(f); });
  copy_out(oval + base, L,
           [&](int i) { return val[base + s.idx[pad4(i)]]; });
  copy_out(oids + base, L,
           [&](int i) { return ids[base + s.idx[pad4(i)]]; });
}

// ------------------------------------------------------- the pass floor
//
// pass_floor_flat and pass_floor_rows replace roll_pass_kernel
// (scripts/probe_r4_pallas_sort.py:94-106): `passes` stride-1 compare-
// exchange passes, after which each (even, odd) pair of a row is sorted.
// On the TPU a pair lay across two lanes, so a pass was two pltpu.rolls
// and a select.  Here a thread holds whole pairs in registers and a pass
// is a min and a max on each: no shared memory, no barrier, no shuffle.
//
// What bounds it: at one pass the bytes (the rows in and out once: 134 MB,
// 0.040 ms at 3.35 TB/s for 2^13 rows of 2048); at the probe's 66 the
// integer issue (66 x 2^24 min/max on the ALU pipe, 64 a clock an SM:
// ~0.07 ms on 132 SMs at 1.98 GHz; the card's min/max issue at that half
// rate, so this is the floor).  A thread holds FLOOR_QUADS 16-byte quads
// (two pairs each) a tile, and one trip of the pass loop runs two passes:
// 8 * FLOOR_QUADS min/max against one increment, compare and branch.
//
// Every pass runs.  After the first a pass changes nothing, so a compiler
// that saw through the loop could keep one pass.  It cannot: the count is
// a run-time argument, the loop stays rolled (#pragma unroll 1), and after
// each compare-exchange an empty asm volatile with "+r" operands makes the
// pair's values opaque, so min(min(a, b), max(a, b)) is never folded,
// inside a trip or across trips.
//
// Even L: no pair crosses a row, so the tensor is R * L / 2 independent
// pairs, counted from its first element (a contiguous view can start at
// any 4-byte offset).  A head of at most one pair brings the input, or if
// the input starts at an odd word the output, to 16 bytes; then the
// quads, each side moved by the widest access its alignment allows (one
// int4, two int2 or four words); then a tail of at most one pair.  The
// grid is at most the CTAs the card holds at once, walking tiles of
// FLOOR_THREADS * FLOOR_QUADS quads.  Odd L: pairs restart at each row, a
// warp takes a row with word accesses, and lane 0 copies the last element.
//
// The first version of this kernel ran a CTA a row with up to 1024
// threads, the row in shared memory and a __syncthreads after each pass;
// bound by shared-memory bandwidth, on an NVIDIA H100 80GB HBM3 at 700 W it
// took 0.4585-0.4629 ms for 2^13 x 2048 int32 rows at 66 passes (plain
// version 0.4930-0.4976 ms).

// one compare-exchange pass over the pairs (v[2i], v[2i + 1])
template <int N>
__device__ __forceinline__ void floor_pass(int32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int32_t lo = min(v[i], v[i + 1]), hi = max(v[i], v[i + 1]);
    v[i] = lo;
    v[i + 1] = hi;
    asm volatile("" : "+r"(v[i]), "+r"(v[i + 1]));
  }
}

// `passes` passes, two a trip of the loop: the second writes back the
// registers the first read, so a trip copies no register (with one pass
// a trip the compiler copies each lower value back into the register the
// loop carries, 8 moves beside 16 min/max)
template <int N>
__device__ __forceinline__ void floor_passes(int32_t (&v)[N], int passes) {
#pragma unroll 1
  for (int p = 1; p < passes; p += 2) {
    floor_pass(v);
    floor_pass(v);
  }
  if (passes & 1) floor_pass(v);
}

// the four words at p into v[0..3], V words an access (p is aligned to
// 4 V bytes)
template <int V>
__device__ __forceinline__ void load_quad(const int32_t* __restrict__ p,
                                          int32_t* v) {
  if constexpr (V == 4) {
    const int4 a = *reinterpret_cast<const int4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (V == 2) {
    const int2 a = reinterpret_cast<const int2*>(p)[0];
    const int2 b = reinterpret_cast<const int2*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = p[u];
  }
}

template <int V>
__device__ __forceinline__ void store_quad(int32_t* __restrict__ p,
                                           const int32_t* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    reinterpret_cast<int2*>(p)[0] = make_int2(v[0], v[1]);
    reinterpret_cast<int2*>(p)[1] = make_int2(v[2], v[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) p[u] = v[u];
  }
}

// Even L.  x, out: the tensor's first element.  `head` (0 or 1) pairs,
// then `n_quads` quads, then `tail` (0 or 1) pairs; VL and VS are the
// words a load and a store of the quads move.
template <int VL, int VS>
__global__ void __launch_bounds__(FLOOR_THREADS)
pass_floor_flat(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int head, int64_t n_quads, int tail, int passes) {
  constexpr int64_t TILE = (int64_t)FLOOR_THREADS * FLOOR_QUADS;
  if (blockIdx.x == 0 && threadIdx.x < 2 &&
      (threadIdx.x == 0 ? head : tail)) {
    const int64_t e = threadIdx.x == 0 ? 0 : 2 * head + 4 * n_quads;
    int32_t v[2] = {x[e], x[e + 1]};
    floor_passes(v, passes);
    out[e] = v[0];
    out[e + 1] = v[1];
  }
  const int32_t* xq = x + 2 * head;
  int32_t* oq = out + 2 * head;
  const int64_t tiles = (n_quads + TILE - 1) / TILE;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    int32_t v[4 * FLOOR_QUADS];
#pragma unroll
    for (int q = 0; q < FLOOR_QUADS; ++q) {
      const int64_t i = t * TILE + q * FLOOR_THREADS + threadIdx.x;
      if (i < n_quads) {
        load_quad<VL>(xq + 4 * i, v + 4 * q);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[4 * q + u] = 0;
      }
    }
    floor_passes(v, passes);
#pragma unroll
    for (int q = 0; q < FLOOR_QUADS; ++q) {
      const int64_t i = t * TILE + q * FLOOR_THREADS + threadIdx.x;
      if (i < n_quads) store_quad<VS>(oq + 4 * i, v + 4 * q);
    }
  }
}

// Odd L: a warp a row, word accesses (a row's pairs start at alternating
// word parities), lane 0 copies the row's last element.
__global__ void __launch_bounds__(FLOOR_THREADS)
pass_floor_rows(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int64_t R, int L, int passes) {
  constexpr int WARPS = FLOOR_THREADS / WARP;
  const int lane = threadIdx.x % WARP;
  for (int64_t r = (int64_t)blockIdx.x * WARPS + threadIdx.x / WARP; r < R;
       r += (int64_t)gridDim.x * WARPS) {
    const int32_t* xr = x + r * L;
    int32_t* orow = out + r * L;
    for (int j = lane; j < L / 2; j += WARP) {
      int32_t v[2] = {xr[2 * j], xr[2 * j + 1]};
      floor_passes(v, passes);
      orow[2 * j] = v[0];
      orow[2 * j + 1] = v[1];
    }
    if (lane == 0) orow[L - 1] = xr[L - 1];
  }
}

// whole warps of E positions each, covering L
int sort_threads(int L) {
  return ((L + E - 1) / E + WARP - 1) / WARP * WARP;
}

// CTAs of FLOOR_THREADS that the card holds at once; any grid is right, so
// one device's count serves every call
template <class Kernel>
int resident_ctas(Kernel kernel) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                FLOOR_THREADS, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// words a 16-byte quad access at `addr` may move at once: 4, 2 or 1
int quad_words(uintptr_t addr) {
  const int phase = (int)(addr >> 2) & 3;
  return phase == 0 ? 4 : phase == 2 ? 2 : 1;
}

using FlatLaunch = cudaError_t (*)(const int32_t*, int32_t*, int, int64_t,
                                   int, int, cudaStream_t);

template <int VL, int VS>
cudaError_t launch_flat(const int32_t* x, int32_t* out, int head,
                        int64_t n_quads, int tail, int passes,
                        cudaStream_t s) {
  static const int ctas = resident_ctas(pass_floor_flat<VL, VS>);
  const int64_t tile = (int64_t)FLOOR_THREADS * FLOOR_QUADS;
  const int64_t tiles = (n_quads + tile - 1) / tile;
  const int grid = (int)(tiles < ctas ? (tiles > 0 ? tiles : 1) : ctas);
  pass_floor_flat<VL, VS><<<grid, FLOOR_THREADS, 0, s>>>(
      x, out, head, n_quads, tail, passes);
  return cudaGetLastError();
}

template <int VL>
FlatLaunch flat_for_store(int vs) {
  return vs == 4 ? launch_flat<VL, 4>
                 : vs == 2 ? launch_flat<VL, 2> : launch_flat<VL, 1>;
}

FlatLaunch flat_for(int vl, int vs) {
  return vl == 4 ? flat_for_store<4>(vs)
                 : vl == 2 ? flat_for_store<2>(vs) : flat_for_store<1>(vs);
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
  const size_t smem = (size_t)NW * cap8(L) * sizeof(int64_t) +
                      (size_t)cap4(L) * sizeof(int32_t);
  cudaError_t e = allow_smem(bitonic_keys_kernel<NW>, smem);
  if (e != cudaSuccess) return e;
  bitonic_keys_kernel<NW><<<(unsigned)R, sort_threads(L), smem, s>>>(
      key, val, ids, okey, oval, oids, L);
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
  const size_t smem = (size_t)cap4(L) * sizeof(int32_t);
  cudaError_t e = allow_smem(bitonic_i32_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  bitonic_i32_kernel<<<(unsigned)R, sort_threads(L), smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), L);
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

// x, out: (R, L) int32, each contiguous from any 4-byte address.
// `passes` stride-1 compare-exchange passes over each row's (even, odd)
// pairs; an odd row's last element is copied.  passes = 0 copies x.
extern "C" int mt_pass_floor(const void* x, void* out, int64_t R, int L,
                             int passes, void* stream) {
  if (R < 0 || L < 0 || L > MAX_ROW || R > INT_MAX || passes < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* oi = static_cast<int32_t*>(out);
  if (L % 2) {
    static const int ctas = resident_ctas(pass_floor_rows);
    constexpr int WARPS = FLOOR_THREADS / WARP;
    const int64_t need = (R + WARPS - 1) / WARPS;
    pass_floor_rows<<<(int)(need < ctas ? need : ctas), FLOOR_THREADS, 0,
                      s>>>(xi, oi, R, L, passes);
    return (int)cudaGetLastError();
  }
  const int64_t pairs = R * (L / 2);
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ao = reinterpret_cast<uintptr_t>(out);
  // one head pair when it brings the input to 16 bytes, or the output if
  // the input starts at an odd word
  const int px = (int)(ax >> 2) & 3, po = (int)(ao >> 2) & 3;
  const int head = (px == 2 || (px % 2 && po == 2)) ? 1 : 0;
  const int64_t n_quads = (pairs - head) / 2;
  const int tail = (int)(pairs - head - 2 * n_quads);
  return (int)flat_for(quad_words(ax + 8 * head), quad_words(ao + 8 * head))(
      xi, oi, head, n_quads, tail, passes, s);
}
