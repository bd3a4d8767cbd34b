// K11 echo_step and K12 unique_ids_step: the node steps of the pool-path
// programs, with the pool round's freeze of killed and paused nodes fused.
//
// K11 replaces EchoProgram.step (maelstrom_tpu/nodes/echo.py:28-34): every
// inbox row [N, K] is relabelled as its reply, valid where the request is
// an echo (dest = src, reply_to = mid, type = the reply code, the rest
// passed through), and the per-node round counter `rounds` [N] grows by
// one. K12 replaces UniqueIdsProgram.step (maelstrom_tpu/nodes/
// unique_ids.py:30-46): the generate requests of a node's row are ranked
// in slot order (cumsum - 1), each reply mints b = counter + 1 + rank
// with a = the node index, and `counter` [N] grows by the row's count
// (int32 arithmetic that wraps, as XLA's).
//
// With the optional stall plane [N] (killed or paused nodes,
// maelstrom_tpu/sim.py:104-112, 429-434), a stalled node keeps its
// counter and its rows are written invalid; every other field is written
// as the unstalled step computes it, as the JAX round's freeze leaves
// them.
//
// The outbox fields a step passes through (src, due, mid, c, and a, b
// for echo) or copies from another field (dest = src, reply_to = mid)
// are the inbox's own tensors, as in the plain versions; the kernels
// write only valid, type (and a, b for unique-ids) and the counter.
//
// Bound: bytes. K11 reads valid and type and writes them (10 bytes a
// slot), K12 also writes a and b (18 bytes a slot), both read and write
// the counter (8 bytes a node); no arithmetic to speak of. Design: K11
// is one thread a (node, slot), every access coalesced; K12 is one
// thread a node walking its K slots (the rank is a running count), the
// warp's reads landing in K * 32 consecutive words of each field.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct StepArgs {
  const u8* valid;     // inbox [N, K]
  const int* type;     // inbox [N, K]
  const int* counter;  // [N]
  const u8* stall;     // [N] or null
  u8* o_valid;         // outbox [N, K]
  int* o_type;         // outbox [N, K]
  int *o_a, *o_b;      // outbox [N, K] (unique-ids; null for echo)
  int* o_counter;      // [N]
};
constexpr int kStepPtrs = sizeof(StepArgs) / sizeof(void*);

struct StepInts {
  int N, K, t_req, t_reply;
};

__global__ void echo_kernel(StepArgs A, StepInts I) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)I.N * I.K) return;
  const int n = (int)(i / I.K);
  const bool stalled = A.stall != nullptr && A.stall[n];
  A.o_valid[i] = A.valid[i] && A.type[i] == I.t_req && !stalled;
  A.o_type[i] = I.t_reply;
  if (i % I.K == 0)
    A.o_counter[n] = stalled ? A.counter[n]
                             : (int)((unsigned)A.counter[n] + 1u);
}

__global__ void unique_ids_kernel(StepArgs A, StepInts I) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= I.N) return;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const unsigned counter = (unsigned)A.counter[n];
  unsigned count = 0u;  // generate requests up to and including a slot
  for (int k = 0; k < I.K; ++k) {
    const long long i = (long long)n * I.K + k;
    const bool gen = A.valid[i] && A.type[i] == I.t_req;
    count += gen;
    A.o_valid[i] = gen && !stalled;
    A.o_type[i] = I.t_reply;
    A.o_a[i] = n;
    A.o_b[i] = (int)(counter + count);  // counter + 1 + rank
  }
  A.o_counter[n] = stalled ? (int)counter : (int)(counter + count);
}

int launch(bool unique_ids, void* const* p, int n_ptrs, const long long* v,
           int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kStepPtrs, n_ints, 4))
    return cudaErrorInvalidValue;
  StepArgs A;
  memcpy(&A, p, sizeof(A));
  StepInts I{(int)v[0], (int)v[1], (int)v[2], (int)v[3]};
  if (I.N < 1 || I.K < 1 ||
      (unique_ids && (A.o_a == nullptr || A.o_b == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (unique_ids)
    unique_ids_kernel<<<mt_blocks(I.N, kThreads), kThreads, 0, st>>>(A, I);
  else
    echo_kernel<<<mt_blocks((long long)I.N * I.K, kThreads), kThreads, 0,
                  st>>>(A, I);
  return cudaGetLastError();
}

}  // namespace

// ptrs: the fields of StepArgs in order (stall may be null; o_a and o_b
//       null)
// ints: N, K, the request type code, the reply type code
MT_API int mt_echo_step(void* const* p, int n_ptrs, const long long* v,
                        int n_ints, void* stream) {
  return launch(false, p, n_ptrs, v, n_ints, stream);
}

// as mt_echo_step, with o_a and o_b
MT_API int mt_unique_ids_step(void* const* p, int n_ptrs,
                              const long long* v, int n_ints,
                              void* stream) {
  return launch(true, p, n_ptrs, v, n_ints, stream);
}
