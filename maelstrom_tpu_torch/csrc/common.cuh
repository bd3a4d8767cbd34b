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
