// K32 fleet_hold, K33 wave_reduce, and the fleet forms of K5 and K6: the
// device half of the fleet scan (maelstrom_tpu_torch/sim.py
// make_fleet_scan_fn) and of the fleet's columnar session table
// (maelstrom_tpu_torch/runner/sessions.py ColumnarSessions.encode_wave).
//
// K32 fleet_hold replaces the held-lane select of
// maelstrom_tpu/sim.py:make_fleet_scan_fn (`_mask_held`, :1002-1023) and
// the per-round select that lax.while_loop under vmap makes for a lane
// whose loop has ended. The port runs every lane's round in lockstep (one
// cluster-axis round for all F lanes) and then restores the lanes that
// must not move: for each leaf of a table of (dst, src) pairs, with the
// leaf's bytes a cluster row, dst[f] = src[f] where live[f] is 0. dst is
// the round's new leaf and src the leaf before the round, so this is
// where(live, new, old) written in place into new; for the edge channels,
// which a round updates in place, a first K32 launch saves the held
// lanes' rows into a scratch copy before the round and a second one
// writes them back. Bound: bytes (a held row is read once and written
// once; a live row costs one byte read of its flag). Design: one block a
// cluster row: a live row's block leaves at once, a held one copies its
// row of every leaf in turn, with 16-byte words when both ends and the
// row size allow, 4-byte words next, bytes otherwise.
//
// K33 wave_reduce replaces maelstrom_tpu/runner/sessions.py
// _wave_reduce_fn (:61-82): the two masked minima of the fleet's session
// table, dl[f] = min over s of p_dl[f, s] where p_mid[f, s] >= 0, and
// due[f] = min over r of r_due[f, r] where r_valid[f, r], INT32_MAX for an
// empty row; int32 in and out (the host restores the int64 sentinel, as
// JAX does). Bound: bytes, 8 bytes a pending slot and 5 a requeue slot.
// Design: one block of 128 threads a cluster row, a strided scan per
// thread, then warp reductions (__reduce_min_sync) and a shared pass over
// the four warps.
//
// K5 reply_log_fleet is K5 (scan.cu) with one reply log and one exit
// round a lane: the vmapped append_replies and `cond` of
// maelstrom_tpu/sim.py:_build_scan_fn (:821-845). For every lane f that
// is live this round (live_in[f]) it appends the lane's valid client rows
// cm[f, :] at rn[f] + rank into its log row (positions >= rcap dropped),
// stamps them with the lane's post-round counter round[f], packs the
// payload from the lane's own node rows seen[f * N + clip(src)], updates
// rn[f], and evaluates the lane's exit test go = k < k_max[f] & ~(stop[f]
// & any valid) & rn' + CW <= rcap: where it fails exit_k[f] takes k, and
// live_out[f] = go. n_live counts the lanes live for the next round (the
// host reads it once a chunk of rounds). A held lane (live_in 0) appends
// nothing and stays held. Design: one block a lane, ranking its rows a
// tile of 256 at a time with warp ballots; the ranking and the row write
// are K5's own (common.cuh mt_rank_valid, mt_write_reply_row).
//
// K6 quiet_probe_fleet is K6 (scan.cu) with one flag a cluster: the
// vmapped _quiet of maelstrom_tpu/runner/fleet_runner.py:_probe_quiet
// (:399-411). quiet[f] = no byte set in cluster f's row of any plane.
// Design: one warp a cluster row (rows are a few hundred bytes to a few
// KB), a warp-wide OR over its rows of every plane, 16-byte loads where
// the row allows; each warp writes its cluster's flag.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 96;
constexpr int kMaxPlanes = 8;
constexpr int kInt32Max = 0x7fffffff;

// --- K32 ---------------------------------------------------------------

struct HoldTable {
  char* dst[kMaxLeaves];
  const char* src[kMaxLeaves];
  long long row_bytes[kMaxLeaves];
};

__global__ void hold_kernel(HoldTable T, int leaves,
                            const u8* __restrict__ live) {
  const long long f = blockIdx.x;
  if (live[f]) return;  // uniform across the block
  for (int leaf = 0; leaf < leaves; ++leaf) {
    const long long rb = T.row_bytes[leaf];
    char* d = T.dst[leaf] + f * rb;
    const char* s = T.src[leaf] + f * rb;
    const uintptr_t align = (uintptr_t)d | (uintptr_t)s | (uintptr_t)rb;
    if ((align & 15) == 0) {
      uint4* d4 = reinterpret_cast<uint4*>(d);
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      for (long long i = threadIdx.x; i < rb / 16; i += blockDim.x)
        d4[i] = s4[i];
    } else if ((align & 3) == 0) {
      int* d1 = reinterpret_cast<int*>(d);
      const int* s1 = reinterpret_cast<const int*>(s);
      for (long long i = threadIdx.x; i < rb / 4; i += blockDim.x)
        d1[i] = s1[i];
    } else {
      for (long long i = threadIdx.x; i < rb; i += blockDim.x) d[i] = s[i];
    }
  }
}

// --- K33 ---------------------------------------------------------------

constexpr int kReduceThreads = 128;

__global__ void wave_reduce_kernel(const int* __restrict__ p_mid,
                                   const int* __restrict__ p_dl,
                                   const u8* __restrict__ r_valid,
                                   const int* __restrict__ r_due,
                                   int* __restrict__ dl,
                                   int* __restrict__ due, int S, int R) {
  __shared__ int red[2][kReduceThreads / 32];
  const long long f = blockIdx.x;
  int m_dl = kInt32Max, m_due = kInt32Max;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const long long i = f * S + s;
    if (p_mid[i] >= 0 && p_dl[i] < m_dl) m_dl = p_dl[i];
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const long long i = f * R + r;
    if (r_valid[i] && r_due[i] < m_due) m_due = r_due[i];
  }
  m_dl = __reduce_min_sync(0xffffffffu, m_dl);
  m_due = __reduce_min_sync(0xffffffffu, m_due);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = m_dl;
    red[1][warp] = m_due;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kReduceThreads / 32; ++w) {
      m_dl = min(m_dl, red[0][w]);
      m_due = min(m_due, red[1][w]);
    }
    dl[f] = m_dl;
    due[f] = m_due;
  }
}

// --- K5, a log a lane ----------------------------------------------------

struct FleetLogArgs {
  MtReplyCols cols;   // cm [F, CW], the logs [F, rcap], seen [F * N, V]
  const int* round;   // [F] post-round counters: the stamps
  int* rn;            // [F], updated by the lane's block
  int* exit_k;        // [F]
  const int* k_max;   // [F]
  const u8* stop;     // [F]
  const u8* live_in;  // [F]
  u8* live_out;       // [F]
  int* n_live;        // scalar, zeroed by the entry point
};
constexpr int kFleetLogPtrs = sizeof(FleetLogArgs) / sizeof(void*);

struct FleetLogInts {
  int CW, rcap, W, N, V, k, rows_i32;
};

__global__ void fleet_log_kernel(FleetLogArgs A, FleetLogInts I) {
  __shared__ int warp_base[kWarps];
  const long long f = blockIdx.x;
  if (!A.live_in[f]) {  // a held lane appends nothing and stays held
    if (threadIdx.x == 0) A.live_out[f] = 0;
    return;
  }
  const int rn = A.rn[f];
  const long long lo = f * I.CW;
  const long long vr = mt_rank_valid<kThreads>(
      A.cols.valid, lo, lo + I.CW, warp_base, [&](long long i, long long r) {
        const long long pos = rn + r;
        if (pos >= I.rcap) return;
        const long long o = f * I.rcap + pos;
        if (I.rows_i32)
          mt_write_reply_row<true>(A.cols, i, o, A.round[f], f * I.N, I.N,
                                   I.W, I.V);
        else
          mt_write_reply_row<false>(A.cols, i, o, A.round[f], f * I.N, I.N,
                                    I.W, I.V);
      });
  if (threadIdx.x == 0) {
    const long long rn2 = rn + vr;
    A.rn[f] = (int)rn2;
    const bool go = I.k < A.k_max[f] && !(A.stop[f] && vr > 0) &&
                    rn2 + I.CW <= I.rcap;
    if (!go && A.exit_k[f] > I.k) A.exit_k[f] = I.k;
    A.live_out[f] = go;
    if (go) atomicAdd(A.n_live, 1);
  }
}

// --- K6, a flag a cluster ------------------------------------------------

struct FleetPlanes {
  const u8* ptr[kMaxPlanes];
  long long row[kMaxPlanes];  // bytes a cluster row
  int count;
};

__global__ void quiet_fleet_kernel(FleetPlanes P, u8* __restrict__ quiet,
                                   long long F) {
  const long long f = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (f >= F) return;  // whole warps leave together
  bool busy = false;
  for (int k = 0; k < P.count; ++k) {
    const long long rb = P.row[k];
    const u8* p = P.ptr[k] + f * rb;
    if ((((uintptr_t)p | (uintptr_t)rb) & 15) == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
      for (long long i = lane; i < rb / 16; i += 32) {
        const uint4 x = q[i];
        busy |= (x.x | x.y | x.z | x.w) != 0u;
      }
    } else {
      for (long long i = lane; i < rb; i += 32) busy |= p[i] != 0;
    }
  }
  busy = __any_sync(0xffffffffu, busy);
  if (lane == 0) quiet[f] = !busy;
}

}  // namespace

// K32. ptrs: live (u8 [F]), then (dst, src) pairs, one a leaf (1 to 96
//       leaves); ints: F, then each leaf's bytes a cluster row
MT_API int mt_fleet_hold(void* const* p, int n_ptrs, const long long* v,
                         int n_ints, void* stream) {
  const int leaves = (n_ptrs - 1) / 2;
  if (leaves < 1 || leaves > kMaxLeaves || n_ptrs != 1 + 2 * leaves ||
      n_ints != 1 + leaves || v[0] < 0)
    return cudaErrorInvalidValue;
  HoldTable T;
  for (int k = 0; k < leaves; ++k) {
    T.dst[k] = (char*)p[1 + 2 * k];
    T.src[k] = (const char*)p[2 + 2 * k];
    T.row_bytes[k] = v[1 + k];
    if (T.row_bytes[k] < 0 || !T.dst[k] || !T.src[k])
      return cudaErrorInvalidValue;
  }
  if (v[0] == 0) return cudaSuccess;
  hold_kernel<<<(unsigned)v[0], kThreads, 0, (cudaStream_t)stream>>>(
      T, leaves, (const u8*)p[0]);
  return cudaGetLastError();
}

// K33. ptrs: p_mid [F, S], p_dl [F, S] (int32), r_valid [F, R] (u8),
//       r_due [F, R] (int32), dl [F], due [F] (int32 out); ints: F, S, R
MT_API int mt_wave_reduce(void* const* p, int n_ptrs, const long long* v,
                          int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, 6, n_ints, 3) || v[0] < 0 || v[1] < 1 ||
      v[2] < 1)
    return cudaErrorInvalidValue;
  if (v[0] == 0) return cudaSuccess;
  wave_reduce_kernel<<<(unsigned)v[0], kReduceThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int*)p[0], (const int*)p[1], (const u8*)p[2], (const int*)p[3],
      (int*)p[4], (int*)p[5], (int)v[1], (int)v[2]);
  return cudaGetLastError();
}

// K5's fleet form. ptrs: the fields of FleetLogArgs in order; ints: F, CW,
//       rcap, W, N, V, k, rows_i32 (seen is an [F * N, W] int32 plane)
MT_API int mt_reply_log_fleet(void* const* p, int n_ptrs, const long long* v,
                              int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kFleetLogPtrs, n_ints, 8))
    return cudaErrorInvalidValue;
  FleetLogArgs A;
  memcpy(&A, p, sizeof(A));
  FleetLogInts I = {(int)v[1], (int)v[2], (int)v[3], (int)v[4],
                    (int)v[5], (int)v[6], (int)v[7]};
  const long long F = v[0];
  if (F < 0 || I.CW < 1 || I.rcap < 1 || A.n_live == nullptr ||
      (I.W > 0 && (A.cols.l_plog == nullptr || A.cols.seen == nullptr)) ||
      (I.rows_i32 && I.V != I.W))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(A.n_live, 0, sizeof(int), st);
  if (err != cudaSuccess || F == 0) return err;
  fleet_log_kernel<<<(unsigned)F, kThreads, 0, st>>>(A, I);
  return cudaGetLastError();
}

// K6's fleet form. ptrs: the bool planes (1 to 8), each [F, row], then
//       quiet (u8 [F] out); ints: F, then each plane's bytes a row
MT_API int mt_quiet_probe_fleet(void* const* p, int n_ptrs,
                                const long long* v, int n_ints,
                                void* stream) {
  const int count = n_ptrs - 1;
  if (count < 1 || count > kMaxPlanes || n_ints != count + 1 || v[0] < 0)
    return cudaErrorInvalidValue;
  FleetPlanes P;
  for (int k = 0; k < count; ++k) {
    P.ptr[k] = (const u8*)p[k];
    P.row[k] = v[1 + k];
  }
  P.count = count;
  if (v[0] == 0) return cudaSuccess;
  quiet_fleet_kernel<<<mt_blocks(v[0], kWarps), kThreads, 0,
                       (cudaStream_t)stream>>>(P, (u8*)p[count], v[0]);
  return cudaGetLastError();
}
