// K13 pn_counter_step: one round of the PN-counter node program on the
// edge channels (served to the pn-counter and g-counter workloads).
//
// Replaces maelstrom_tpu/nodes/pn_counter.py:PnCounterProgram.edge_step
// (:87-175). State: per-origin contributions pos / neg [N, M] int32 (M = N
// origins) and the per-edge bits pending / synced [N, D, M]. A round
//   - adds the client deltas of a node's K slots to its own origin (int32
//     sums that wrap, as XLA's);
//   - merges the entries (origin a, pos b, neg c) arriving on its D x L
//     edge lanes by origin max, where p_in / n_in start at the -1 of "no
//     entry" and an entry's origin is clip(a, 0, M - 1);
//   - sets synced where an arriving entry is >= the merged one, clears it
//     where the origin changed, and queues pending by the teach, echo and
//     retry rules;
//   - sends per edge the rotating top per_nb pending origins (a, b, c =
//     origin, merged pos, merged neg) and clears their pending bits;
//   - answers add and read requests (add_ok / read_ok).
//
// Bound: bytes. pos and neg are read and written once (16 bytes an
// origin), pending and synced too (4 bytes an origin and edge), the lanes
// once: at 1,000 nodes of degree up to 9 some 52 MB a round. Design: one
// block a node, a thread an origin, origins taken in the rotated order of
// the selection. The node's D x L lanes are staged in shared memory and
// each thread folds the entries of its own origin from there, so the
// [N, D, M] p_in / n_in planes of the JAX version never exist; the
// thread then updates pending and synced in registers edge by edge and
// writes each plane once, coalesced.
//
// The rotating top_k: priorities M - ((o - round * per_nb) mod M) are
// distinct for pending origins and 0 for the rest, so lax.top_k takes the
// first per_nb pending origins in cyclic order from s = (round * per_nb)
// mod M (round * per_nb within int32, as any run's round is). Thread t of
// chunk c owns rotated position r = c * blockDim + t, origin (s + r) mod
// M, and a block-wide prefix count of pending bits in that order is each
// origin's lane. Where fewer than per_nb are pending, top_k fills the
// remaining lanes with the 0-priority ties in index order: the
// lowest-index origins that are not pending (all among the first 2
// per_nb), written invalid with their merged pos and neg, as JAX does.
//
// The optional stall plane [N] (killed or paused nodes, the JAX round's
// freeze, maelstrom_tpu/sim.py:94-112, 476-488): a stalled node writes
// its old state and no valid edge or client row; every other output field
// is what the unstalled step computes.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int T_ADD = 10, T_ADD_OK = 11, T_READ = 12, T_READ_OK = 13;
constexpr int T_ENTRY = 14;

// pointer arguments, in the order the Python wrapper passes them
struct StepArgs {
  const int *pos, *neg;       // [N, M]
  const u8 *pending, *synced;  // [N, D, M]
  const u8* e_valid;           // [N, D, L]
  const int *e_type, *e_a, *e_b, *e_c;
  const u8* c_valid;  // [N, K]
  const int *c_src, *c_due, *c_mid, *c_type, *c_a, *c_b, *c_c;
  const int *neighbors, *round;  // [N, D], scalar
  const u8* stall;               // [N] or null
  int *o_pos, *o_neg;
  u8 *o_pending, *o_synced;
  u8* oe_valid;  // [N, D, P]
  int *oe_type, *oe_a, *oe_b, *oe_c;
  u8* oc_valid;  // [N, K]
  int *oc_src, *oc_dest, *oc_due, *oc_mid, *oc_reply_to, *oc_type, *oc_a,
      *oc_b, *oc_c;
};
constexpr int kStepPtrs = sizeof(StepArgs) / sizeof(void*);

struct StepInts {
  int N, D, M, L, K, P, retry, low;  // low = min(2 P, M)
};

// exclusive prefix count of `p` over the block in thread order; `total`
// gets the block's count. Every thread must call it.
__device__ int block_rank(bool p, int* warp_cnt, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, p);
  __syncthreads();  // warp_cnt may still be read from the last call
  if (lane == 0) warp_cnt[warp] = __popc(m);
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) before += warp_cnt[w];
    sum += warp_cnt[w];
  }
  total = sum;
  return before + __popc(m & ((1u << lane) - 1u));
}

__global__ void pn_counter_kernel(StepArgs A, StepInts I) {
  extern __shared__ int smem[];
  const int n = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int DL = I.D * I.L;
  int* s_o = smem;                // [D L] entry origin, -1 for none
  int* s_b = s_o + DL;            // [D L]
  int* s_c = s_b + DL;            // [D L]
  int* warp_cnt = s_c + DL;       // [32]
  int* base = warp_cnt + 32;      // [D] pending origins ranked so far
  int* low_pos = base + I.D;      // [low] merged pos of origins < low
  int* low_neg = low_pos + I.low;
  int* dpn = low_neg + I.low;     // [2] the node's dpos, dneg
  u8* low_pend = reinterpret_cast<u8*>(dpn + 2);  // [D, low]
  const bool stalled = A.stall != nullptr && A.stall[n];

  for (int i = t; i < DL; i += T) {
    const long long g = (long long)n * DL + i;
    const bool e = A.e_valid[g] && A.e_type[g] == T_ENTRY;
    s_o[i] = e ? mt_clip(A.e_a[g], 0, I.M - 1) : -1;
    s_b[i] = A.e_b[g];
    s_c[i] = A.e_c[g];
  }
  for (int d = t; d < I.D; d += T) base[d] = 0;
  // client slots: the replies, and the node's own-origin deltas
  for (int k = t; k < I.K; k += T) {
    const long long i = (long long)n * I.K + k;
    const bool add = A.c_valid[i] && A.c_type[i] == T_ADD;
    const bool read = A.c_valid[i] && A.c_type[i] == T_READ;
    A.oc_valid[i] = (add || read) && !stalled;
    A.oc_src[i] = A.c_src[i];
    A.oc_dest[i] = A.c_src[i];
    A.oc_due[i] = A.c_due[i];
    A.oc_mid[i] = A.c_mid[i];
    A.oc_reply_to[i] = A.c_mid[i];
    A.oc_type[i] = add ? T_ADD_OK : (read ? T_READ_OK : 0);
    A.oc_a[i] = 0;
    A.oc_b[i] = A.c_b[i];
    A.oc_c[i] = A.c_c[i];
  }
  if (t == 0) {
    unsigned dp = 0u, dn = 0u;
    for (int k = 0; k < I.K; ++k) {
      const long long i = (long long)n * I.K + k;
      if (!(A.c_valid[i] && A.c_type[i] == T_ADD)) continue;
      const int x = A.c_a[i];
      const int nx = (int)(0u - (unsigned)x);  // -x, wrapping
      dp += (unsigned)(x > 0 ? x : 0);
      dn += (unsigned)(nx > 0 ? nx : 0);
    }
    dpn[0] = (int)dp;
    dpn[1] = (int)dn;
  }
  __syncthreads();
  const int dpos = dpn[0], dneg = dpn[1];
  const int rnd = *A.round;
  const bool requeue = mt_mod(rnd, I.retry) == 0;
  const int s = mt_mod((int)((unsigned)rnd * (unsigned)I.P), I.M);

  for (int c0 = 0; c0 < I.M; c0 += T) {
    const int r = c0 + t;
    const bool act = r < I.M;
    const int o = act ? (s + r) % I.M : 0;
    const long long ro = (long long)n * I.M + o;
    int pos = 0, neg = 0, pos2 = 0, neg2 = 0;
    bool changed = false, nonzero = false;
    if (act) {
      pos = A.pos[ro];
      neg = A.neg[ro];
      if (o == n) {
        pos = (int)((unsigned)pos + (unsigned)dpos);
        neg = (int)((unsigned)neg + (unsigned)dneg);
      }
      int pm = -1, nm = -1;
      for (int i = 0; i < DL; ++i)
        if (s_o[i] == o) {
          pm = max(pm, s_b[i]);
          nm = max(nm, s_c[i]);
        }
      pos2 = max(pos, pm);
      neg2 = max(neg, nm);
      changed = pos2 > pos || neg2 > neg ||
                (o == n && (dpos > 0 || dneg > 0));
      nonzero = pos2 > 0 || neg2 > 0;
      A.o_pos[ro] = stalled ? A.pos[ro] : pos2;
      A.o_neg[ro] = stalled ? A.neg[ro] : neg2;
      if (o < I.low) {
        low_pos[o] = pos2;
        low_neg[o] = neg2;
      }
    }
    for (int d = 0; d < I.D; ++d) {
      bool pe = false, sy = false, pe0 = false, sy0 = false;
      const bool ok = A.neighbors[(long long)n * I.D + d] >= 0;
      const long long g = ((long long)n * I.D + d) * I.M + o;
      if (act) {
        int pd = -1, nd = -1;
        for (int l = 0; l < I.L; ++l) {
          const int i = d * I.L + l;
          if (s_o[i] == o) {
            pd = max(pd, s_b[i]);
            nd = max(nd, s_c[i]);
          }
        }
        const bool arrived = pd >= 0;
        const bool nb_ge = arrived && pd >= pos2 && nd >= neg2;
        pe0 = A.pending[g];
        sy0 = A.synced[g];
        sy = (sy0 && !changed) || nb_ge;
        pe = (pe0 && !nb_ge) || (changed && ok && !nb_ge) ||
             (arrived && !sy0 && ok) || (requeue && !sy && nonzero && ok);
        if (o < I.low) low_pend[d * I.low + o] = pe;
      }
      int total;
      const int before = block_rank(pe, warp_cnt, total);
      const int rank = base[d] + before;  // read after block_rank's syncs
      const bool sel = pe && rank < I.P;
      if (sel) {
        const long long j = ((long long)n * I.D + d) * I.P + rank;
        A.oe_valid[j] = ok && !stalled;
        A.oe_type[j] = T_ENTRY;
        A.oe_a[j] = o;
        A.oe_b[j] = pos2;
        A.oe_c[j] = neg2;
      }
      if (act) {
        A.o_pending[g] = stalled ? pe0 : (pe && !sel);
        A.o_synced[g] = stalled ? sy0 : sy;
      }
      __syncthreads();  // every thread has read base[d]
      if (t == 0) base[d] += total;
    }
  }
  __syncthreads();
  // lanes past the pending origins: the lowest-index others, invalid
  for (int d = t; d < I.D; d += T) {
    int j = base[d];
    for (int o = 0; o < I.low && j < I.P; ++o) {
      if (low_pend[d * I.low + o]) continue;
      const long long q = ((long long)n * I.D + d) * I.P + j;
      A.oe_valid[q] = 0;
      A.oe_type[q] = T_ENTRY;
      A.oe_a[q] = o;
      A.oe_b[q] = low_pos[o];
      A.oe_c[q] = low_neg[o];
      ++j;
    }
  }
}

}  // namespace

// ptrs: the fields of StepArgs in order (stall may be null)
// ints: N, D, M, L (edge-in lanes), K (client slots), P (per_nb, the
//       out lanes, 1 <= P <= M), retry_rounds
MT_API int mt_pn_counter_step(void* const* p, int n_ptrs,
                              const long long* v, int n_ints,
                              void* stream) {
  if (mt_bad_args(n_ptrs, kStepPtrs, n_ints, 7))
    return cudaErrorInvalidValue;
  StepArgs A;
  memcpy(&A, p, sizeof(A));
  StepInts I;
  I.N = (int)v[0];
  I.D = (int)v[1];
  I.M = (int)v[2];
  I.L = (int)v[3];
  I.K = (int)v[4];
  I.P = (int)v[5];
  I.retry = (int)v[6];
  I.low = 2 * I.P < I.M ? 2 * I.P : I.M;
  if (I.N < 1 || I.D < 1 || I.M < 1 || I.L < 1 || I.K < 1 || I.P < 1 ||
      I.P > I.M || I.retry < 1)
    return cudaErrorInvalidValue;
  int threads = ((I.M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem =
      sizeof(int) * (3 * (size_t)I.D * I.L + 32 + I.D + 2 * I.low + 2) +
      (size_t)I.D * I.low;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pn_counter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  pn_counter_kernel<<<I.N, threads, smem, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}
