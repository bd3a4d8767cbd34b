// K7 threefry: the simulation's random draws, one launch per draw.
//
// Replaces the threefry draws of the JAX package's round: the key splits
// (jax.random.split in maelstrom_tpu/sim.py:464-468 and
// maelstrom_tpu/net/tpu.py:289-292, whose raw pairs are the counters'
// hashes), the uniforms of the loss and duplication rolls
// (net/tpu.py:306, :319-323) and draw_latency_rounds (net/tpu.py:238-250)
// for the flight pool. Modes:
//   0 split    out uint32 [n, 2]: (bits1, bits2) of counter base + i
//   1 bits     out uint32 [n]: bits1 ^ bits2
//   2 uniform  out float32 [n]
//   3 mask     out bool [n]: uniform < *p
//   4 latency  out int32 [n]: rounds of the uniform (dist 1) or
//              exponential (dist 2) distribution of mean
//              float32(mean_rounds) * *scale
// The counter of element i is the pair (i >> 32, i & 0xFFFFFFFF), as
// jax/_src/prng.py iota_2x32_shape makes it. With a batch of keys [F, 2]
// (per_key > 0: jax.random under vmap, one key a cluster) element i
// hashes key i / per_key with counter i mod per_key, so F clusters' splits,
// bits, masks or latency rounds take one launch; the masks and latency
// rounds then read p[i / per_key] and scale[i / per_key], a cluster's own
// probability and latency scale ([F] float32).
//
// Bound: about 80 integer operations a draw for the 20 threefry rounds
// against 4 bytes written, so at the card's int32 rate the kernel is
// bound by operations, not bytes. Design: one thread a draw, the key in
// registers; the subkeys of a round come from one split launch, so the
// key chain never leaves the card.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void threefry_kernel(const unsigned* __restrict__ key,
                                long long n, unsigned long long base,
                                int mode, int dist, float mean_rounds,
                                long long per_key,
                                const float* __restrict__ p,
                                const float* __restrict__ scale,
                                void* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long kf = per_key > 0 ? i / per_key : 0;
  key += 2 * kf;
  const unsigned long long c =
      base + (unsigned long long)(per_key > 0 ? i % per_key : i);
  if (mode == 0) {
    unsigned x0 = (unsigned)(c >> 32), x1 = (unsigned)c;
    mt_threefry2x32(key[0], key[1], x0, x1);
    ((unsigned*)out)[2 * i] = x0;
    ((unsigned*)out)[2 * i + 1] = x1;
    return;
  }
  const unsigned bits = mt_random_bits(key, c);
  if (mode == 1) {
    ((unsigned*)out)[i] = bits;
    return;
  }
  const float u = mt_unit(bits);
  if (mode == 2) {
    ((float*)out)[i] = u;
  } else if (mode == 3) {
    ((u8*)out)[i] = u < p[kf];
  } else {
    ((int*)out)[i] = mt_latency(u, dist, __fmul_rn(mean_rounds, scale[kf]));
  }
}

}  // namespace

// ptrs: key (uint32[2], or [F, 2] with per_key > 0), out, p (mode 3,
//       else null), scale (mode 4, else null); p and scale are scalars, or
//       [F] with per_key > 0
// ints: n (all elements), counter base, mode, dist, float32 bits of
//       mean_rounds, per_key (elements a key; 0 = one key for all)
MT_API int mt_threefry(void* const* p, int n_ptrs, const long long* v,
                       int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, 4, n_ints, 6)) return cudaErrorInvalidValue;
  const long long n = v[0];
  const int mode = (int)v[2];
  if (mode < 0 || mode > 4 || (mode == 3 && !p[2]) || (mode == 4 && !p[3])
      || v[5] < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned mbits = (unsigned)v[4];
  float mean;
  memcpy(&mean, &mbits, sizeof(mean));
  threefry_kernel<<<mt_blocks(n, kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const unsigned*)p[0], n, (unsigned long long)v[1], mode, (int)v[3],
      mean, v[5], (const float*)p[2], (const float*)p[3], p[1]);
  return cudaGetLastError();
}
