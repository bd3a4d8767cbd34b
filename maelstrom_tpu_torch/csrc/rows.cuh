// Byte planes read and written 16 values a lane, and rows of P lanes of a
// warp: the helpers K3 (broadcast.cu) and K15 (broadcast_batched.cu)
// share. A plane row holds one bool byte a value; a lane moves the 16
// values [v0, v0 + 16) of its row as one 16-byte word and keeps them as
// 16 bits (bit k for value v0 + k).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// --- 16 values a lane: bytes <-> bits -------------------------------------

// four bytes (any nonzero byte is true) to bits 0-3, byte k to bit k
__device__ __forceinline__ unsigned pack4(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned pack16(uint4 q) {
  return pack4(q.x) | pack4(q.y) << 4 | pack4(q.z) << 8 | pack4(q.w) << 12;
}

// bits 0-3 to four 0/1 bytes
__device__ __forceinline__ unsigned unpack4(unsigned b) {
  return ((b & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint4 unpack16(unsigned m) {
  return make_uint4(unpack4(m), unpack4(m >> 4), unpack4(m >> 8),
                    unpack4(m >> 12));
}

// bits k of the 16 values v0 + k that lie in [0, V)
__device__ __forceinline__ unsigned range16(int v0, int V) {
  if (v0 + 16 <= 0 || v0 >= V) return 0u;
  unsigned m = 0xFFFFu;
  if (v0 < 0) m &= 0xFFFFu << -v0;
  if (v0 + 16 > V) m &= 0xFFFFu >> (v0 + 16 - V);
  return m & 0xFFFFu;
}

// bits k of the 16 values v0 + k below `start`
__device__ __forceinline__ unsigned below16(int v0, int start) {
  if (start <= v0) return 0u;
  if (start >= v0 + 16) return 0xFFFFu;
  return (1u << (start - v0)) - 1u;
}

// The bits of the chunk [v0, v0 + 16) of a row: kVec from the 16-byte
// word q the caller loaded at row + v0 (aligned), else byte by byte.
template <bool kVec>
__device__ __forceinline__ unsigned bits16(uint4 q, const u8* row, int v0,
                                           int V) {
  if (kVec) return pack16(q) & range16(v0, V);
  unsigned m = 0u;
  for (int k = 0; k < 16; ++k) {
    const int v = v0 + k;
    if (v >= 0 && v < V && row[v]) m |= 1u << k;
  }
  return m;
}

// The bits of the chunk [v0, v0 + 16) of a row at any byte offset: the
// one or two aligned 16-byte words that hold its bytes in [0, V). A word
// may reach past the row into its neighbours, never past the 16-byte
// block of the row's first or last byte.
__device__ __forceinline__ unsigned bits16_at(const u8* row, int v0, int V) {
  const unsigned m = range16(v0, V);
  if (!m) return 0u;
  const int lo = v0 < 0 ? 0 : v0, hi = v0 + 16 > V ? V : v0 + 16;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(row + lo) & ~uintptr_t(15);
  const uintptr_t a1 =
      reinterpret_cast<uintptr_t>(row + hi - 1) & ~uintptr_t(15);
  unsigned w = pack16(__ldg(reinterpret_cast<const uint4*>(a0)));
  if (a1 != a0) w |= pack16(__ldg(reinterpret_cast<const uint4*>(a1))) << 16;
  // value v0 + k is byte (row + v0 + k - a0) of the 32 bits in w
  const int off = (int)((long long)reinterpret_cast<uintptr_t>(row) + v0 -
                        (long long)a0);
  return (off >= 0 ? w >> off : w << -off) & m;
}

// stores the 16 bits as bytes, those of values in [0, V) only
template <bool kVec>
__device__ __forceinline__ void store16(u8* row, int v0, int V,
                                        unsigned m) {
  if (v0 + 16 <= 0 || v0 >= V) return;
  if (kVec && v0 >= 0 && v0 + 16 <= V) {
    __stcs(reinterpret_cast<uint4*>(row + v0), unpack16(m));
    return;
  }
  for (int k = 0; k < 16; ++k) {
    const int v = v0 + k;
    if (v >= 0 && v < V) row[v] = (m >> k) & 1u;
  }
}

// the digest's bits of the 16 values v0 + k: value v is covered when
// j = v - w_in * 64 (int32 wrap, as in the JAX version) is in [0, 64)
__device__ __forceinline__ unsigned digest16(bool has, unsigned long long dig,
                                             unsigned base, int v0) {
  if (!has) return 0u;
  const int off = (int)((unsigned)v0 - base);  // j of value v0
  if (off >= 64 || off <= -16) return 0u;
  const unsigned long long w = off >= 0 ? dig >> off : dig << -off;
  return (unsigned)w & 0xFFFFu;
}

// --- a row's lanes: P of the warp's 32 -------------------------------------

// The lanes of one row: P (a power of two) lanes from lane `base`, sl the
// lane's place among them. Every helper is called by all 32 lanes, each
// row's segment reducing over its own lanes.
struct Seg {
  int P, sl, base;
  unsigned low;  // the P low bits
};

__device__ __forceinline__ Seg make_seg(int P) {
  const int lane = threadIdx.x & 31;
  Seg g;
  g.P = P;
  g.sl = lane & (P - 1);
  g.base = lane & ~(P - 1);
  g.low = P == 32 ? kFull : (1u << P) - 1u;
  return g;
}

__device__ __forceinline__ unsigned seg_ballot(const Seg& g, bool x) {
  return (__ballot_sync(kFull, x) >> g.base) & g.low;
}

__device__ __forceinline__ int seg_add(const Seg& g, int x) {
  for (int o = g.P >> 1; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ unsigned seg_or(const Seg& g, unsigned x) {
  for (int o = g.P >> 1; o; o >>= 1) x |= __shfl_xor_sync(kFull, x, o);
  return x;
}

// inclusive prefix sum over the row's lanes
__device__ __forceinline__ unsigned seg_scan(const Seg& g, unsigned x) {
  for (int o = 1; o < g.P; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (g.sl >= o) x += y;
  }
  return x;
}

// inclusive prefix maximum over the row's lanes
__device__ __forceinline__ int seg_max_scan(const Seg& g, int x) {
  for (int o = 1; o < g.P; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (g.sl >= o && y > x) x = y;
  }
  return x;
}

__device__ __forceinline__ int seg_get(const Seg& g, int x, int src) {
  return __shfl_sync(kFull, x, g.base + src);
}

}  // namespace
