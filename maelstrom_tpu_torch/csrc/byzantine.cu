// K30 byz_corrupt_pool and K31 byz_corrupt_edge: the byzantine
// adversary's in-round rewrite of the culprit's outbox row
// (maelstrom_tpu/byzantine.py).
//
// K30 replaces corrupt_pool (byzantine.py:163-175, through _gate :129,
// culprit_rows :137 and _apply :144) with the compartment's byz_wire
// (nodes/compartment.py:1444-1474): on the culprit's valid lanes of the
// wired type (T_ASSIGN) of the [N, L] pool-path outbox, equivocation sets
// b ^= (((round ^ delta) & 0x3F) | 1) << 8, and with S > 1 stale-ballot
// repacks a as ((culprit + 1) % S) << 24 | client << 12 | slot.
// K31 replaces corrupt_edge (byzantine.py:178-187) with the batched
// program's byz_wire_edge (nodes/broadcast_batched.py:92-113): on the
// culprit's valid lanes of the wired type (T_BATCH_OK) of the [N, K]
// client-reply batch, forged-proof sets b += 1 + (delta & 3) on odd
// rounds and c ^= (delta & 0xFFFF) | 1 on even ones.
//
// Both read the carry (active, attack, culprit, delta, rate_q, injected)
// and the round from device memory: no host sync. The gate is active and
// ((round * -1640531535 + delta) & 0x7FFFFFFF) % 1000 < rate_q, the
// product and sum in unsigned 32-bit arithmetic (int32's wrap). One block
// walks the culprit's row, a lane a thread, and rewrites the selected
// lanes in place (the outbox is the step's fresh output, never carried;
// the wrappers in byzantine.py say why that is safe); it writes nothing
// of the row when the culprit is out of [0, N), the gate is closed or
// the attack is one the kernel does not wire. Thread 0 writes the ledger
// to a NEW [3] tensor: injected + (the rewritten lanes at the attack's
// slot), so the scan's rollback keeps the old carry.
//
// Bound: bytes. One row's valid and type planes and the rewritten words
// (L lanes x 13 bytes at most) plus 40 bytes of carry; a launch is a few
// microseconds of latency whatever the row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEquivocation = 0, kForgedProof = 1, kStaleBallot = 2;

struct CorruptArgs {
  const u8* valid;      // [N, L]
  const int* type;      // [N, L]
  int* w1;              // K30: a; K31: b  ([N, L], rewritten in place)
  int* w2;              // K30: b; K31: c
  const int *active, *attack, *culprit, *delta, *rate_q;  // [1] each
  const int* injected;  // [3]
  const int* round;     // [1]
  int* o_injected;      // [3]
};
constexpr int kPtrs = sizeof(CorruptArgs) / sizeof(void*);

__device__ __forceinline__ bool gate(const CorruptArgs& A, int rnd) {
  const unsigned h = ((unsigned)rnd * (unsigned)(-1640531535) +
                      (unsigned)A.delta[0]) & 0x7FFFFFFFu;
  return A.active[0] > 0 && (int)(h % 1000u) < A.rate_q[0];
}

// kEdge false: K30 (w1 = a, w2 = b); true: K31 (w1 = b, w2 = c)
template <bool kEdge>
__global__ void corrupt_kernel(CorruptArgs A, int N, int L, int msg_type,
                               int S) {
  __shared__ int s_count;
  const int t = threadIdx.x;
  const int rnd = A.round[0], culprit = A.culprit[0], attack = A.attack[0];
  const int delta = A.delta[0];
  const bool wired = kEdge ? attack == kForgedProof
                           : (attack == kEquivocation ||
                              (attack == kStaleBallot && S > 1));
  const bool open = wired && culprit >= 0 && culprit < N && gate(A, rnd);
  if (t == 0) s_count = 0;
  __syncthreads();
  if (open) {
    const long long row = (long long)culprit * L;
    int mine = 0;
    for (int l = t; l < L; l += blockDim.x) {
      const long long i = row + l;
      if (!A.valid[i] || A.type[i] != msg_type) continue;
      ++mine;
      if (kEdge) {
        if (rnd & 1)
          A.w1[i] = (int)((unsigned)A.w1[i] + 1u + (unsigned)(delta & 3));
        else
          A.w2[i] = A.w2[i] ^ ((delta & 0xFFFF) | 1);
      } else if (attack == kEquivocation) {
        A.w2[i] = A.w2[i] ^ ((((rnd ^ delta) & 0x3F) | 1) << 8);
      } else {
        const int a = A.w1[i];
        const int bal = mt_mod(culprit + 1, S);
        A.w1[i] = (int)(((unsigned)bal << 24) |
                        ((unsigned)((a >> 12) & 0xFFF) << 12) |
                        (unsigned)(a & 0xFFF));
      }
    }
    if (mine) atomicAdd(&s_count, mine);
  }
  __syncthreads();
  if (t < 3)
    A.o_injected[t] = (int)((unsigned)A.injected[t] +
                            (unsigned)(open && t == attack ? s_count : 0));
}

int launch(void* const* p, int n_ptrs, const long long* v, int n_ints,
           int want_ints, bool edge, void* stream) {
  if (mt_bad_args(n_ptrs, kPtrs, n_ints, want_ints))
    return cudaErrorInvalidValue;
  CorruptArgs A;
  for (int j = 0; j < kPtrs; ++j) ((void**)&A)[j] = p[j];
  const int N = (int)v[0], L = (int)v[1], msg_type = (int)v[2];
  const int S = edge ? 1 : (int)v[3];
  if (N < 1 || L < 1 || S < 1) return cudaErrorInvalidValue;
  if (edge)
    corrupt_kernel<true><<<1, kThreads, 0, (cudaStream_t)stream>>>(
        A, N, L, msg_type, S);
  else
    corrupt_kernel<false><<<1, kThreads, 0, (cudaStream_t)stream>>>(
        A, N, L, msg_type, S);
  return cudaGetLastError();
}

}  // namespace

// ptrs: the outbox's valid, type, a, b ([N, L]); the carry's active,
//       attack, culprit, delta, rate_q, injected; round; o_injected ([3])
// ints: N, L, msg_type (T_ASSIGN), S (sequencers: stale-ballot when > 1)
MT_API int mt_byz_corrupt_pool(void* const* p, int n_ptrs,
                               const long long* v, int n_ints,
                               void* stream) {
  return launch(p, n_ptrs, v, n_ints, 4, false, stream);
}

// ptrs: the client batch's valid, type, b, c ([N, K]); the carry's
//       active, attack, culprit, delta, rate_q, injected; round;
//       o_injected ([3])
// ints: N, K, msg_type (T_BATCH_OK)
MT_API int mt_byz_corrupt_edge(void* const* p, int n_ptrs,
                               const long long* v, int n_ints,
                               void* stream) {
  return launch(p, n_ptrs, v, n_ints, 3, true, stream);
}
