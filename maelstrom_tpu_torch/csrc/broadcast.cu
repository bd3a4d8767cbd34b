// K3 broadcast edge_step: one round of the gossip node program.
//
// Replaces maelstrom_tpu/nodes/broadcast.py:BroadcastProgram.edge_step
// (:205) with its helpers _select_gossip (:128), _digest_known (:144),
// _digest_out (:173) and the V <= 64 read-reply packing of
// _pack_seen_words (:338). All three modes: efficient (send once plus
// retry), eager resend, and naive (with or without skip_sender).
//
// Bound: the state is five byte planes, three of them [N, D, V], read and
// written once a round (about 180 MB at 100k nodes, D 4, V 64), so the
// kernel is bound by device-memory bytes. Design: one warp per node. Lane
// i of the warp owns value v = 32 * chunk + i, so every plane row is read
// and written as 32 neighbouring bytes, and the warp turns its per-value
// bits into 32-bit masks with __ballot_sync. The masks of one node (seen,
// new, and per edge pending, inflight, arrived) live in shared memory, so
// the reductions of the JAX version (any over edges, the first owed
// window, the rotating top_k) are bit scans inside the warp and nothing
// is written twice.
//
// The rotating top_k: priorities V - ((v - round * per_nb) mod V) are
// distinct for pending values, so the selection is the first per_nb
// pending values in cyclic order from (round * per_nb) mod V. Where fewer
// are pending, jax.lax.top_k fills the remaining slots with the 0-priority
// ties in index order, that is the lowest-index values that are not
// pending; the kernel writes the same values into edge_out.a.
//
// The stall mask (mt_broadcast_step_stall) is the JAX round's freeze of
// killed and paused nodes (maelstrom_tpu/sim.py:_freeze_nodes, :94-112,
// and the output masks at :476-488): a stalled node writes its old planes
// into the fresh ones and no valid edge or client row. Folding it into the
// step saves a second pass over the [N, D, V] planes.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int T_BCAST = 10, T_BCAST_OK = 11, T_READ = 12, T_READ_OK = 13;
constexpr int T_GOSSIP = 14, T_DIGEST = 15;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 8;     // nodes per block
constexpr int kMasks = 7;     // shared mask arrays per warp

// pointer arguments, in the order the Python wrapper passes them
struct StepArgs {
  const u8 *seen, *pending, *inflight, *inflight_old, *owed;
  const u8* e_valid;
  const int *e_type, *e_a, *e_b, *e_c;
  const u8* c_valid;
  const int *c_src, *c_due, *c_mid, *c_type, *c_a, *c_b, *c_c;
  const int *neighbors, *round;
  u8 *o_seen, *o_pending, *o_inflight, *o_inflight_old, *o_owed;
  u8* oe_valid;
  int *oe_type, *oe_a, *oe_b, *oe_c;
  u8* oc_valid;
  int *oc_src, *oc_dest, *oc_due, *oc_mid, *oc_reply_to, *oc_type, *oc_a,
      *oc_b, *oc_c;
  // [N] killed or paused nodes (mt_broadcast_step_stall); null otherwise
  const u8* stall;
};
constexpr int kStepPtrs = sizeof(StepArgs) / sizeof(void*);

struct StepDims {
  int N, D, V, W, L, K, Lout, per_nb, retry, naive, skip_sender, eager;
  // nodes a cluster on the cluster axis (N = F * nc node rows: row n
  // reads neighbors[n % nc] and round[n / nc]); 0 for one cluster, whose
  // round is a scalar
  int nc;
};

__device__ __forceinline__ bool bit_of(const unsigned* m, int v) {
  return (m[v >> 5] >> (v & 31)) & 1u;
}

// lowest index in [from, to) whose bit in m equals `want`, or -1
__device__ int next_bit(const unsigned* m, int from, int to, bool want) {
  while (from < to) {
    unsigned w = m[from >> 5];
    if (!want) w = ~w;
    w &= FULL << (from & 31);
    if (w) {
      int v = (from & ~31) + __ffs(w) - 1;
      return v < to ? v : -1;
    }
    from = (from & ~31) + 32;
  }
  return -1;
}

__global__ void step_kernel(StepArgs A, StepDims S) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= S.N) return;  // whole warps leave together; no block barrier
  const int V = S.V, D = S.D, L = S.L, Cp = 2 * S.W;
  unsigned* sm = smem + (size_t)warp * kMasks * Cp;
  unsigned* smask = sm;           // seen' bits
  unsigned* nmask = sm + Cp;      // new bits
  unsigned* amask = sm + 2 * Cp;  // arrived on the current edge
  unsigned* pmask = sm + 3 * Cp;  // pending' on the current edge
  unsigned* imask = sm + 4 * Cp;  // inflight' on the current edge
  unsigned* fmask = sm + 5 * Cp;  // naive: arrived on an earlier edge
  unsigned* tmask = sm + 6 * Cp;  // sent on the current edge
  const int round = S.nc > 0 ? A.round[n / S.nc] : *A.round;
  const long long nV = (long long)n * V;
  const long long local = S.nc > 0 ? n % S.nc : n;  // the table's row
  // a stalled node keeps its planes and sends nothing
  const bool st = A.stall != nullptr && A.stall[n] != 0;

  // --- pass 1: client broadcasts and gossip arrivals fold into seen ---
  for (int c = 0; c < Cp; ++c) {
    const int v = c * 32 + lane;
    const bool inb = v < V;
    bool s2 = false, nw = false;
    if (inb) {
      bool got = false;
      for (int k = 0; k < S.K; ++k) {
        long long i = (long long)n * S.K + k;
        if (A.c_valid[i] && A.c_type[i] == T_BCAST &&
            mt_clip(A.c_a[i], 0, V - 1) == v)
          got = true;
      }
      for (int i = 0; i < D * L; ++i) {
        long long e = (long long)n * D * L + i;
        if (A.e_valid[e] && A.e_type[e] == T_GOSSIP &&
            mt_clip(A.e_a[e], 0, V - 1) == v)
          got = true;
      }
      const bool s = A.seen[nV + v] != 0;
      nw = got && !s;
      s2 = s || got;
      A.o_seen[nV + v] = st ? s : s2;
    }
    const unsigned sb = __ballot_sync(FULL, s2);
    const unsigned nb = __ballot_sync(FULL, nw);
    if (lane == 0) {
      smask[c] = sb;
      nmask[c] = nb;
      fmask[c] = 0;
    }
  }
  __syncwarp();

  // --- client replies ---
  for (int k = lane; k < S.K; k += 32) {
    long long i = (long long)n * S.K + k;
    const bool cb = A.c_valid[i] && A.c_type[i] == T_BCAST;
    const bool rd = A.c_valid[i] && A.c_type[i] == T_READ;
    A.oc_valid[i] = (cb || rd) && !st;
    A.oc_src[i] = A.c_src[i];
    A.oc_dest[i] = A.c_src[i];
    A.oc_due[i] = A.c_due[i];
    A.oc_mid[i] = A.c_mid[i];
    A.oc_reply_to[i] = A.c_mid[i];
    A.oc_type[i] = cb ? T_BCAST_OK : (rd ? T_READ_OK : 0);
    A.oc_a[i] = 0;
    if (V <= 64) {  // the seen bitmap rides the read reply
      A.oc_b[i] = rd ? (int)smask[0] : 0;
      A.oc_c[i] = rd ? (int)smask[1] : 0;
    } else {
      A.oc_b[i] = A.c_b[i];
      A.oc_c[i] = A.c_c[i];
    }
  }

  const bool requeue = mt_mod(round, S.retry) == 0;
  const int start = (int)(((long long)round * S.per_nb % V + V) % V);
  const int goff = S.naive ? 0 : 1;  // gossip lanes follow the digest lane

  // --- pass 2: per edge ---
  for (int d = 0; d < D; ++d) {
    const long long nd = (long long)n * D + d;
    const long long ndV = nd * V;
    const bool eok = A.neighbors[local * D + d] >= 0;
    bool has_dig = false;
    int w_in = 0, b_in = 0, c_in = 0;
    if (!S.naive) {
      for (int l = 0; l < L; ++l) {  // the last digest lane wins
        long long e = nd * L + l;
        if (A.e_valid[e] && A.e_type[e] == T_DIGEST) {
          has_dig = true;
          w_in = A.e_a[e];
          b_in = A.e_b[e];
          c_in = A.e_c[e];
        }
      }
    }
    for (int c = 0; c < Cp; ++c) {
      const int v = c * 32 + lane;
      const bool inb = v < V;
      const unsigned fm = fmask[c];
      bool arr = false;
      if (inb) {
        for (int l = 0; l < L; ++l) {
          long long e = nd * L + l;
          if (A.e_valid[e] && A.e_type[e] == T_GOSSIP &&
              mt_clip(A.e_a[e], 0, V - 1) == v)
            arr = true;
        }
      }
      const unsigned ab = __ballot_sync(FULL, arr);
      const bool nw = (nmask[c] >> lane) & 1u;
      bool pend = false, i2 = false;
      if (S.naive) {
        const bool first = ((ab & ~fm) >> lane) & 1u;
        const bool known = S.skip_sender && first;
        if (inb) pend = (A.pending[ndV + v] || (nw && eok)) && !known;
      } else if (inb) {
        bool nh = false;
        if (has_dig) {  // int32 wrap as in the JAX version
          const int j = (int)((unsigned)v - (unsigned)w_in * 64u);
          if (j >= 0 && j < 64)
            nh = j < 32 ? (((unsigned)b_in >> j) & 1u)
                        : (((unsigned)c_in >> (j - 32)) & 1u);
        }
        const bool known = arr || nh;
        const bool p0 = A.pending[ndV + v] != 0;
        const bool f0 = A.inflight[ndV + v] != 0;
        const bool o0 = A.inflight_old[ndV + v] != 0;
        pend = (p0 || (nw && eok) || (o0 && requeue)) && !known;
        A.o_inflight_old[ndV + v] =
            st ? o0 : (requeue ? f0 : o0) && !known;
        i2 = f0 && !known && !requeue;
      }
      const unsigned pb = __ballot_sync(FULL, pend);
      const unsigned ib = __ballot_sync(FULL, i2);
      if (lane == 0) {
        pmask[c] = pb;
        imask[c] = ib;
        amask[c] = ab;
        fmask[c] = fm | ab;
        tmask[c] = 0;
      }
    }
    __syncwarp();

    // rotating selection (lane 0): first per_nb pending values in cyclic
    // order from `start`, then the lowest-index non-pending values
    if (lane == 0) {
      int cnt = 0;
      for (int seg = 0; seg < 2 && cnt < S.per_nb; ++seg) {
        int p = seg == 0 ? start : 0;
        const int hi = seg == 0 ? V : start;
        while (cnt < S.per_nb) {
          p = next_bit(pmask, p, hi, true);
          if (p < 0) break;
          const long long o = nd * S.Lout + goff + cnt;
          A.oe_valid[o] = eok && !st;
          A.oe_a[o] = p;
          tmask[p >> 5] |= 1u << (p & 31);
          ++cnt;
          ++p;
        }
      }
      int p = 0;
      while (cnt < S.per_nb) {
        p = next_bit(pmask, p, V, false);
        const long long o = nd * S.Lout + goff + cnt;
        A.oe_valid[o] = 0;
        A.oe_a[o] = p;
        ++cnt;
        ++p;
      }
      for (int j = 0; j < S.per_nb; ++j) {
        const long long o = nd * S.Lout + goff + j;
        A.oe_type[o] = T_GOSSIP;
        A.oe_b[o] = 0;
        A.oe_c[o] = 0;
      }
    }
    __syncwarp();

    for (int c = 0; c < Cp; ++c) {
      const int v = c * 32 + lane;
      if (v >= V) break;
      const bool pend = bit_of(pmask, v), sent = bit_of(tmask, v);
      if (st) {
        A.o_pending[ndV + v] = A.pending[ndV + v];
        if (!S.naive) A.o_inflight[ndV + v] = A.inflight[ndV + v];
      } else if (S.naive) {
        A.o_pending[ndV + v] = pend && !sent;
      } else if (S.eager) {
        A.o_pending[ndV + v] = pend;
        A.o_inflight[ndV + v] = bit_of(imask, v);
      } else {
        A.o_pending[ndV + v] = pend && !sent;
        A.o_inflight[ndV + v] = bit_of(imask, v) || sent;
      }
    }

    if (!S.naive) {
      // owe the windows gossip arrived in; pay the lowest owed one
      int w_send = -1;
      for (int w0 = 0; w0 < S.W; w0 += 32) {
        const int w = w0 + lane;
        bool o = false;
        if (w < S.W)
          o = A.owed[nd * S.W + w] || amask[2 * w] || amask[2 * w + 1];
        const unsigned ob = __ballot_sync(FULL, o);
        if (ob && w_send < 0) w_send = w0 + __ffs(ob) - 1;
        if (w < S.W)
          A.o_owed[nd * S.W + w] =
              st ? A.owed[nd * S.W + w] : o && w != w_send;
      }
      if (lane == 0) {
        const bool have = w_send >= 0;
        const int ws = have ? w_send : 0;
        const long long o = nd * S.Lout;
        A.oe_valid[o] = have && eok && !st;
        A.oe_type[o] = T_DIGEST;
        A.oe_a[o] = ws;
        A.oe_b[o] = (int)smask[2 * ws];
        A.oe_c[o] = (int)smask[2 * ws + 1];
      }
    }
    __syncwarp();
  }
}

}  // namespace

namespace {

int launch_step(void* const* p, int n_ptrs, const long long* v, int n_ints,
                void* stream, bool with_stall) {
  if (mt_bad_args(n_ptrs, kStepPtrs - (with_stall ? 0 : 1), n_ints, 13) ||
      v[12] < 0 || (v[12] > 0 && v[0] % v[12]))
    return cudaErrorInvalidValue;
  StepArgs args;
  memcpy(&args, p, sizeof(void*) * n_ptrs);
  if (!with_stall)
    args.stall = nullptr;
  else if (args.stall == nullptr)
    return cudaErrorInvalidValue;
  StepDims dims = {(int)v[0], (int)v[1], (int)v[2],  (int)v[3],
                   (int)v[4], (int)v[5], (int)v[6],  (int)v[7],
                   (int)v[8], (int)v[9], (int)v[10], (int)v[11],
                   (int)v[12]};
  if (dims.N == 0) return cudaSuccess;
  size_t smem = (size_t)kWarps * kMasks * 2 * dims.W * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  step_kernel<<<mt_blocks(dims.N, kWarps), kWarps * 32, smem,
                (cudaStream_t)stream>>>(args, dims);
  return cudaGetLastError();
}

}  // namespace

// ptrs: the fields of StepArgs in order but the last (stall); ints: the
// fields of StepDims (nc last: 0 for one cluster and a scalar round, else
// the nodes a cluster of the F * nc rows, neighbors the [nc, D] table of
// one cluster and round an [F] array)
MT_API int mt_broadcast_step(void* const* p, int n_ptrs, const long long* v,
                             int n_ints, void* stream) {
  return launch_step(p, n_ptrs, v, n_ints, stream, false);
}

// K3 with the stall mask (enable_stall): ptrs: every field of StepArgs,
// the [N] stall mask last
MT_API int mt_broadcast_step_stall(void* const* p, int n_ptrs,
                                   const long long* v, int n_ints,
                                   void* stream) {
  return launch_step(p, n_ptrs, v, n_ints, stream, true);
}
