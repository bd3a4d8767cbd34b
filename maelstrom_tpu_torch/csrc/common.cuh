// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes; see maelstrom_tpu_torch/kernels/__init__.py).
//
// Every entry point has the signature
//   int mt_<name>(void* const* ptrs, int n_ptrs,
//                 const long long* ints, int n_ints, void* stream)
// and returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue when the argument counts are wrong. bool tensors
// are one byte (uint8_t here), all other tensors int32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MT_API extern "C" __attribute__((visibility("default")))

typedef uint8_t u8;

static inline int mt_bad_args(int n_ptrs, int want_ptrs, int n_ints,
                              int want_ints) {
  return n_ptrs != want_ptrs || n_ints != want_ints;
}

// floor modulo, as jnp's % on int32 (the result takes the divisor's sign)
__device__ __forceinline__ int mt_mod(int x, int m) {
  int r = x % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__device__ __forceinline__ int mt_clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

static inline unsigned mt_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// --- threefry2x32 (jax.random in partitionable mode) ------------------------
//
// K7 (prng.cu) and K8 (faults.cu) draw the JAX package's random numbers:
// the 20-round threefry2x32 of jax/_src/prng.py, counters (i >> 32,
// i & 0xFFFFFFFF) for flat index i. The float steps use the _rn
// intrinsics so that nvcc never contracts them into an FMA: each is one
// float32 rounding, as in XLA.

__device__ __forceinline__ unsigned mt_rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void mt_threefry2x32(unsigned k0, unsigned k1,
                                                unsigned& x0, unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = mt_rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
}

// 32 random bits at flat index i of `key`'s stream (bits1 ^ bits2)
__device__ __forceinline__ unsigned mt_random_bits(const unsigned* key,
                                                   unsigned long long i) {
  unsigned x0 = (unsigned)(i >> 32), x1 = (unsigned)i;
  mt_threefry2x32(key[0], key[1], x0, x1);
  return x0 ^ x1;
}

// jax.random.uniform's float in [0, 1): 23 random mantissa bits
__device__ __forceinline__ float mt_unit(unsigned bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3f800000u), 1.0f);
}

// latency rounds from a uniform u (net/tpu.py draw_latency_rounds):
// dist 1 uniform over [0, 2 mean], dist 2 exponential of that mean;
// rintf rounds half to even, as jnp.round
__device__ __forceinline__ int mt_latency(float u, int dist, float mean) {
  const float x = dist == 1 ? __fmul_rn(u, __fmul_rn(2.0f, mean))
                            : __fmul_rn(-log1pf(-u), mean);
  return (int)rintf(x);
}

// Adds the block's sum of each x[k] to *dst[k] with one atomic a counter
// (skipped when the sum is 0): a warp reduction, shared-memory atomics,
// then one global atomic. Integer sums, so any order gives the same
// total. Every thread of the block must call it; blockDim.x is a
// multiple of 32.
template <int NC>
__device__ __forceinline__ void mt_block_add(const int (&x)[NC],
                                             int* const (&dst)[NC]) {
  __shared__ int s[NC];
  if (threadIdx.x < NC) s[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int w = __reduce_add_sync(0xffffffffu, x[k]);
    if ((threadIdx.x & 31) == 0 && w) atomicAdd(&s[k], w);
  }
  __syncthreads();
  if (threadIdx.x < NC && s[threadIdx.x])
    atomicAdd(dst[threadIdx.x], s[threadIdx.x]);
}

// --- the reply log (K5 in scan.cu, its fleet form in fleet.cu) -------------
//
// A round's client rows cm and the log's columns, in the order both entry
// points pass them: plog [rcap, W] and seen null when W == 0.
struct MtReplyCols {
  const u8* valid;
  const int *src, *dest, *due, *mid, *reply_to, *type, *a, *b, *c;
  u8* l_valid;
  int *l_src, *l_dest, *l_due, *l_mid, *l_reply_to, *l_type, *l_a, *l_b,
      *l_c, *l_rounds, *l_plog;
  const u8* seen;
};

// Writes client row i at log position o: its ten Msgs fields, the round
// stamp, and the W payload words of node row node0 + clip(src, 0, N - 1)
// of seen: with kRows the row of an int32 plane [., W] as it is, else the
// bool row [., V] packed 32 values a word, low bit first, bit 31 kept as
// the sign as JAX's int32 sums keep it.
template <bool kRows>
__device__ __forceinline__ void mt_write_reply_row(
    const MtReplyCols& C, long long i, long long o, int stamp,
    long long node0, int N, int W, int V) {
  C.l_valid[o] = 1;
  C.l_src[o] = C.src[i];
  C.l_dest[o] = C.dest[i];
  C.l_due[o] = C.due[i];
  C.l_mid[o] = C.mid[i];
  C.l_reply_to[o] = C.reply_to[i];
  C.l_type[o] = C.type[i];
  C.l_a[o] = C.a[i];
  C.l_b[o] = C.b[i];
  C.l_c[o] = C.c[i];
  C.l_rounds[o] = stamp;
  if (W == 0) return;
  const long long node = node0 + mt_clip(C.src[i], 0, N - 1);
  if (kRows) {
    const int* row = reinterpret_cast<const int*>(C.seen) + node * W;
    for (int w = 0; w < W; ++w) C.l_plog[o * W + w] = row[w];
    return;
  }
  const u8* row = C.seen + node * V;
  for (int w = 0; w < W; ++w) {
    unsigned word = 0u;
    for (int j = 0; j < 32; ++j) {
      const int v = w * 32 + j;
      if (v < V && row[v]) word |= 1u << j;
    }
    C.l_plog[o * W + w] = (int)word;
  }
}

// Ranks the valid rows of valid[lo, hi) a tile of kThreads at a time with
// warp ballots and calls emit(i, r) for each valid row i, r its rank among
// the valid rows from lo; returns their count. warp_base is a __shared__
// int[kThreads / 32]. Every thread of the block (of kThreads) calls it.
template <int kThreads, class Emit>
__device__ __forceinline__ long long mt_rank_valid(const u8* valid,
                                                   long long lo,
                                                   long long hi,
                                                   int* warp_base,
                                                   Emit emit) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  long long vr = 0;  // valid rows before the current tile
  for (long long tile = lo; tile < hi; tile += kThreads) {
    const long long i = tile + t;
    const bool v = i < hi && valid[i] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, v);
    __syncthreads();  // warp_base may still be read by the last tile
    if (lane == 0) warp_base[warp] = __popc(m);
    __syncthreads();
    int wb = 0, tile_valid = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) wb += warp_base[w];
      tile_valid += warp_base[w];
    }
    if (v) emit(i, vr + wb + __popc(m & ((1u << lane) - 1u)));
    vr += tile_valid;
  }
  return vr;
}
