// K15 batched-broadcast edge_step: one round of the batched atomic
// broadcast node program.
//
// Replaces maelstrom_tpu/nodes/broadcast_batched.py:
// BroadcastBatchedProgram.edge_step (:140) with _select_ranges (:115),
// and the parent protocol it reuses (_digest_known, _digest_out of
// maelstrom_tpu/nodes/broadcast.py:144, :173): range-gossip arrivals
// expanded into seen, client batches expanded with their count and
// checksum proof, digest receive and send, the retry ticks, and up to
// per_nb maximal runs of pending ids per edge.
//
// Bound: the state is five byte planes, three of them [N, D, V], read and
// written once a round, so the kernel is bound by device-memory bytes.
// Design (K3's, csrc/broadcast.cu): one warp per node. Lane i of the warp
// owns value v = 32 * chunk + i, so every plane row is read and written
// as 32 neighbouring bytes, and the warp turns its per-value bits into
// 32-bit masks with __ballot_sync. The masks of one node (seen, new, and
// per edge arrived, pending, inflight and sent) live in shared memory.
// The run extraction is then a bit scan by lane 0: lo is the first set
// bit of the pending mask from a cursor, the run ends at the next clear
// bit (or V), and the next run is searched from there, per_nb times. An
// edge with nothing left writes lo 0 and n 0 with valid false, as JAX's
// argmax of all-false gives.
//
// The proof: the expanded range is [lo, min(lo + n, V)) with lo and n
// clipped to [0, V]. Its count is exact; its checksum is JAX's int32 sum
// of the ids, which wraps once the ids pass 65,536, then the floor mod by
// 2^31 - 1. The sum is taken in 64 bits and truncated to 32, which is the
// wrapped int32 sum.
//
// The masks grow with V (six of 2 * W words a warp), so the nodes a block
// holds are chosen at launch: up to 8 in shared memory, fewer for a large
// V. Past the shared-memory budget (V above some 270,000) the masks go
// to a global scratch allocated on the stream, and a bounded set of warps
// strides over the nodes, so any V launches.
//
// The stall mask (mt_broadcast_batched_step_stall) is the JAX round's
// freeze of killed and paused nodes (maelstrom_tpu/sim.py:94-112, and the
// output masks at :476-488): a stalled node writes its old planes into
// the fresh ones and no valid edge or client row.
#include <algorithm>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int T_DIGEST = 15;
constexpr int T_BATCH = 20, T_BATCH_OK = 21, T_BREAD = 22, T_BREAD_OK = 23;
constexpr int T_GRANGE = 24;
constexpr int PROOF_MOD = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kMaxWarps = 8;          // nodes per block, at most
constexpr int kMasks = 6;             // shared mask arrays per warp
constexpr size_t kSmemBudget = 200 * 1024;
constexpr int kGlobalWarps = 1024;    // striding warps, at most
constexpr int kGlobalBlockWarps = 4;  // warps a block, global masks
constexpr size_t kScratchBudget = size_t(256) << 20;

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
  // [N] killed or paused nodes (the stall entry point); null otherwise
  const u8* stall;
};
constexpr int kStepPtrs = sizeof(StepArgs) / sizeof(void*);

struct StepDims {
  int N, D, V, W, L, K, Lout, per_nb, retry, eager, warps;
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

// sets the bits [lo, hi) of m
__device__ void set_range(unsigned* m, int lo, int hi) {
  while (lo < hi) {
    const int w = lo >> 5, b = lo & 31;
    const int cnt = min(32 - b, hi - lo);
    const unsigned bits = cnt == 32 ? FULL : ((1u << cnt) - 1u) << b;
    m[w] |= bits;
    lo += cnt;
  }
}

// does the valid T_GRANGE lane e of edge_in cover value v
__device__ __forceinline__ bool range_has(const StepArgs& A, long long e,
                                          int V, int v) {
  if (!A.e_valid[e] || A.e_type[e] != T_GRANGE) return false;
  const int lo = mt_clip(A.e_a[e], 0, V);
  const int hi = lo + mt_clip(A.e_b[e], 0, V);
  return v >= lo && v < hi;
}

// kGlobal false: the masks in shared memory, a warp a node; true: each
// warp of the grid has kMasks * 2W words of the scratch and strides over
// the nodes. Two instantiations, so that each keeps its own registers and
// the shared one addresses its masks as shared memory.
template <bool kGlobal>
__global__ void step_kernel(StepArgs A, StepDims S, unsigned* scratch) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * S.warps + warp;
  const int V = S.V, D = S.D, L = S.L, Cp = 2 * S.W;
  unsigned* sm = kGlobal ? scratch + (size_t)gw * kMasks * Cp
                         : smem + (size_t)warp * kMasks * Cp;
  // whole warps leave together, no block barrier; one trip when shared
  for (int n = gw; n < S.N; n = kGlobal ? n + gridDim.x * S.warps : S.N) {
    unsigned* smask = sm;           // seen' bits
    unsigned* nmask = sm + Cp;      // new bits
    unsigned* amask = sm + 2 * Cp;  // arrived on the current edge
    unsigned* pmask = sm + 3 * Cp;  // pending' on the current edge
    unsigned* imask = sm + 4 * Cp;  // inflight' on the current edge
    unsigned* tmask = sm + 5 * Cp;  // sent (the ranges) on the current edge
    const int round = *A.round;
    const long long nV = (long long)n * V;
    const long long nK = (long long)n * S.K;
    // a stalled node keeps its planes and sends nothing
    const bool st = A.stall != nullptr && A.stall[n] != 0;

    // --- pass 1: client batches and range arrivals fold into seen ---
    for (int c = 0; c < Cp; ++c) {
      const int v = c * 32 + lane;
      bool s2 = false, nw = false;
      if (v < V) {
        bool got = false;
        for (int k = 0; k < S.K; ++k) {
          const long long i = nK + k;
          if (A.c_valid[i] && A.c_type[i] == T_BATCH) {
            const int lo = mt_clip(A.c_a[i], 0, V);
            const int hi = lo + mt_clip(A.c_b[i], 0, V);
            if (v >= lo && v < hi) got = true;
          }
        }
        const long long e0 = (long long)n * D * L;
        for (int e = 0; e < D * L; ++e)
          if (range_has(A, e0 + e, V, v)) got = true;
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
      }
    }
    __syncwarp();

    // --- client replies: batch acks carry the expansion proof ---
    for (int k = lane; k < S.K; k += 32) {
      const long long i = nK + k;
      const bool isb = A.c_valid[i] && A.c_type[i] == T_BATCH;
      const bool rd = A.c_valid[i] && A.c_type[i] == T_BREAD;
      const int lo = mt_clip(A.c_a[i], 0, V);
      const int hi = min(lo + mt_clip(A.c_b[i], 0, V), V);
      const long long cnt = hi > lo ? hi - lo : 0;
      // the ids' sum, truncated to 32 bits: JAX's wrapping int32 sum
      const unsigned long long sum =
          (unsigned long long)(cnt * lo + cnt * (cnt - 1) / 2);
      const int proof = mt_mod((int)(unsigned)sum, PROOF_MOD);
      A.oc_valid[i] = (isb || rd) && !st;
      A.oc_src[i] = A.c_src[i];
      A.oc_dest[i] = A.c_src[i];
      A.oc_due[i] = A.c_due[i];
      A.oc_mid[i] = A.c_mid[i];
      A.oc_reply_to[i] = A.c_mid[i];
      A.oc_type[i] = isb ? T_BATCH_OK : (rd ? T_BREAD_OK : 0);
      A.oc_a[i] = isb ? A.c_a[i] : 0;
      A.oc_b[i] = isb ? (int)cnt : 0;
      A.oc_c[i] = isb ? proof : 0;
    }

    const bool requeue = mt_mod(round, S.retry) == 0;

    // --- pass 2: per edge ---
    for (int d = 0; d < D; ++d) {
      const long long nd = (long long)n * D + d;
      const long long ndV = nd * V;
      const bool eok = A.neighbors[nd] >= 0;
      bool has_dig = false;
      int w_in = 0, b_in = 0, c_in = 0;
      for (int l = 0; l < L; ++l) {  // the last digest lane wins
        const long long e = nd * L + l;
        if (A.e_valid[e] && A.e_type[e] == T_DIGEST) {
          has_dig = true;
          w_in = A.e_a[e];
          b_in = A.e_b[e];
          c_in = A.e_c[e];
        }
      }
      for (int c = 0; c < Cp; ++c) {
        const int v = c * 32 + lane;
        const bool inb = v < V;
        bool arr = false;
        if (inb)
          for (int l = 0; l < L; ++l)
            if (range_has(A, nd * L + l, V, v)) arr = true;
        const unsigned ab = __ballot_sync(FULL, arr);
        const bool nw = (nmask[c] >> lane) & 1u;
        bool pend = false, i2 = false;
        if (inb) {
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
          tmask[c] = 0;
        }
      }
      __syncwarp();

      // maximal runs of pending ids (lane 0): lanes 1..per_nb
      if (lane == 0) {
        int cur = 0;
        for (int j = 0; j < S.per_nb; ++j) {
          const long long o = nd * S.Lout + 1 + j;
          int lo = next_bit(pmask, cur, V, true);
          const bool has = lo >= 0;
          int cnt = 0;
          if (has) {
            int end = next_bit(pmask, lo, V, false);
            if (end < 0) end = V;
            cnt = end - lo;
            set_range(tmask, lo, end);
            cur = end;
          } else {
            lo = 0;
          }
          A.oe_valid[o] = has && eok && !st;
          A.oe_type[o] = T_GRANGE;
          A.oe_a[o] = lo;
          A.oe_b[o] = cnt;
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
          A.o_inflight[ndV + v] = A.inflight[ndV + v];
        } else if (S.eager) {
          A.o_pending[ndV + v] = pend;
          A.o_inflight[ndV + v] = bit_of(imask, v);
        } else {
          A.o_pending[ndV + v] = pend && !sent;
          A.o_inflight[ndV + v] = bit_of(imask, v) || sent;
        }
      }

      // owe the windows ranges arrived in; pay the lowest owed one
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
      __syncwarp();
    }
    __syncwarp();
  }
}

int launch_step(void* const* p, int n_ptrs, const long long* v, int n_ints,
                void* stream, bool with_stall) {
  if (mt_bad_args(n_ptrs, kStepPtrs - (with_stall ? 0 : 1), n_ints, 10))
    return cudaErrorInvalidValue;
  StepArgs args;
  memcpy(&args, p, sizeof(void*) * n_ptrs);
  if (!with_stall)
    args.stall = nullptr;
  else if (args.stall == nullptr)
    return cudaErrorInvalidValue;
  StepDims dims = {(int)v[0], (int)v[1], (int)v[2], (int)v[3], (int)v[4],
                   (int)v[5], (int)v[6], (int)v[7], (int)v[8], (int)v[9], 0};
  if (dims.Lout != dims.per_nb + 1 || dims.W * 64 < dims.V)
    return cudaErrorInvalidValue;
  if (dims.N == 0) return cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t per_warp = (size_t)kMasks * 2 * dims.W * sizeof(unsigned);
  if (per_warp <= kSmemBudget) {
    dims.warps = (int)std::min<size_t>(kMaxWarps, kSmemBudget / per_warp);
    const size_t smem = per_warp * dims.warps;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          step_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
    step_kernel<false><<<mt_blocks(dims.N, dims.warps), dims.warps * 32,
                         smem, st>>>(args, dims, nullptr);
    return cudaGetLastError();
  }
  // past the shared-memory budget: a bounded set of warps, each with its
  // masks in a scratch allocated and freed on the stream
  const size_t warps = std::min<size_t>(
      std::min<size_t>(dims.N, kGlobalWarps),
      std::max<size_t>(1, kScratchBudget / per_warp));
  dims.warps = kGlobalBlockWarps;
  const unsigned blocks = mt_blocks((long long)warps, dims.warps);
  unsigned* scratch = nullptr;
  cudaError_t err = cudaMallocAsync((void**)&scratch,
                                    per_warp * blocks * dims.warps, st);
  if (err != cudaSuccess) return err;
  step_kernel<true><<<blocks, dims.warps * 32, 0, st>>>(args, dims, scratch);
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(scratch, st);
  return err != cudaSuccess ? err : freed;
}

}  // namespace

// ptrs: the fields of StepArgs in order but the last (stall); ints: the
// fields of StepDims but the last (warps, chosen here)
MT_API int mt_broadcast_batched_step(void* const* p, int n_ptrs,
                                     const long long* v, int n_ints,
                                     void* stream) {
  return launch_step(p, n_ptrs, v, n_ints, stream, false);
}

// K15 with the stall mask (enable_stall): ptrs: every field of StepArgs,
// the [N] stall mask last
MT_API int mt_broadcast_batched_step_stall(void* const* p, int n_ptrs,
                                           const long long* v, int n_ints,
                                           void* stream) {
  return launch_step(p, n_ptrs, v, n_ints, stream, true);
}
