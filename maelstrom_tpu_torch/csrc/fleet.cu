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
// once; a live row costs one byte read of its flag): 176 MB, 0.0526 ms at
// 3.35 TB/s, for 3,100 held rows of the 10,000-cluster lin-kv carry.
//
// The first design (one block of 256 threads a cluster row, the leaves
// walked in turn, 0.1201 ms there) left most threads idle on leaves of a
// few hundred bytes, waited on memory once a leaf, since a leaf's loads
// were not issued before the last one's stores, and copied narrow leaves
// byte by byte. This design:
//
// - A row's leaves are one flat space of 16-byte chunks, leaf k's from
//   off[k] (the prefix table that the wrapper builds, sim.py hold_plan,
//   cached by the shapes: rb / 16 chunks for a leaf of rb bytes a row,
//   a multiple of 16, else ceil((rb + 15) / 16) cut on the 16-byte grid
//   of the row's address, so that its middle chunks are aligned at any
//   row offset). A thread finds its first chunk's leaf by a binary
//   search of the table in shared memory and walks forward from it.
// - A block takes R rows and a slice of S chunks of each: it reads the R
//   live flags at once, lists its held rows in shared memory, and its
//   threads stride over (held row, chunk) pairs, so a row's bytes spread
//   over all the threads of its block, and a wide row over several
//   blocks (the 64-cluster broadcast carry: 1.08 MB a row). R and S come
//   from the plan: S at most 1,024 chunks (four a thread), R x S about
//   4,096. A thread's chunks sit at the same places in every row, so
//   their leaves are found once.
// - Each thread holds kHoldBatch chunks in registers: their loads, through
//   the non-coherent path (no pair's src is another's dst; the wrapper
//   checks), are issued before any of its stores.
// - A chunk whose two ends are 16-byte aligned moves as one 16-byte word;
//   a partial head or tail chunk, and any chunk whose source and
//   destination differ in alignment, moves as 4-byte words and bytes,
//   held in registers like the others, so no chunk waits on its own load
//   before the batch's other loads issue.
// - The leaf table is staged in shared memory a leaf a warp at a time, so
//   each read of the parameter bank is one address for the whole warp.
//
// On the card (NVIDIA H100 80GB HBM3, 700 W): 0.078 ms on the lin-kv
// carry (a torch copy of the held rows' bytes, contiguous, 0.061), 0.025
// on the fleet bench's (bound 0.010): JAX's F-led leaves scatter a held
// row over every leaf's tensor, 127 bytes a leaf on the bench's carry,
// and its loads alone reach 0.86 TB/s (PERF.md section 6,
// scripts/time_kernels.py).
//
// scripts/time_kernels.py --variants times its parts by building this
// source with MT_K32_PART set: 1 without its stores (the loads' words
// summed into a flag no launch writes), 2 without its loads (zeros
// stored), 3 the live flags and held lists alone.

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

constexpr int kHoldThreads = 256;
constexpr int kHoldBatch = 4;  // chunks a thread holds at once
constexpr int kHoldPos = 4;  // chunks of a row a thread copies, at most
#ifndef MT_K32_PART
#define MT_K32_PART 0  // the kernel; else a part of it (see the header)
#endif

struct HoldTable {
  char* dst[kMaxLeaves];
  const char* src[kMaxLeaves];
  long long row_bytes[kMaxLeaves];
  int off[kMaxLeaves + 1];  // chunk offsets: leaf k's chunks from off[k]
};

// A chunk in registers: its 16 bytes (or n < 16 of them) as four words,
// moved as one 16-byte word (both ends 16-byte aligned, n 16), as 4-byte
// words and a byte tail (both ends 4-byte aligned) or as bytes.
struct HoldChunk {
  uint4 q;
  char* d;
  int n, mode;  // mode 0 none, 1 a 16-byte word, 2 words, 3 bytes
};

// word w of the chunk: a 4-byte load where the chunk's ends allow, else
// its bytes below n; every index known at compile time, so q stays in
// registers
__device__ __forceinline__ unsigned hold_word(const HoldChunk& c,
                                              const char* s, int w) {
  if (c.mode == 2 && 4 * w + 4 <= c.n)
    return (unsigned)__ldg(reinterpret_cast<const int*>(s + 4 * w));
  unsigned x = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * w + b < c.n)
      x |= (unsigned)(unsigned char)__ldg(s + 4 * w + b) << (8 * b);
  return x;
}

__device__ __forceinline__ void hold_load(HoldChunk& c, const char* s) {
  c.q = make_uint4(0, 0, 0, 0);
  if (MT_K32_PART == 2 || c.mode == 0) return;
  if (c.mode == 1) {
    c.q = __ldg(reinterpret_cast<const uint4*>(s));
    return;
  }
  c.q = make_uint4(hold_word(c, s, 0), hold_word(c, s, 1),
                   hold_word(c, s, 2), hold_word(c, s, 3));
}

__device__ __forceinline__ void hold_put(const HoldChunk& c, int w,
                                         unsigned x) {
  if (c.mode == 2 && 4 * w + 4 <= c.n) {
    *reinterpret_cast<unsigned*>(c.d + 4 * w) = x;
    return;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * w + b < c.n) c.d[4 * w + b] = (char)(x >> (8 * b));
}

__device__ __forceinline__ void hold_store(const HoldChunk& c) {
  if (c.mode == 1) {
    *reinterpret_cast<uint4*>(c.d) = c.q;
  } else if (c.mode != 0) {
    hold_put(c, 0, c.q.x);
    hold_put(c, 1, c.q.y);
    hold_put(c, 2, c.q.z);
    hold_put(c, 3, c.q.w);
  }
}

// Leaf k's chunks in the plan: a leaf of a multiple of 16 bytes a row has
// rb / 16, cut from the row's start; any other leaf ceil((rb + 15) / 16),
// cut on the 16-byte grid of the source row's address (its head and tail
// partial, some chunk empty), so its middle chunks move as aligned words
// whatever the row's offset.
inline long long hold_chunks(long long rb) {
  return rb % 16 == 0 ? rb / 16 : (rb + 30) / 16;
}

// chunk c of leaf k in cluster row f: its bytes, and its loads issued
__device__ __forceinline__ void hold_chunk(HoldChunk& ch, char* const* dst,
                                           const char* const* src,
                                           const long long* rbs,
                                           const int* off, int k, int c,
                                           long long f) {
  const long long rb = rbs[k], at = f * rb;
  const char* sr = src[k] + at;
  long long lo = 16LL * (c - off[k]), hi = lo + 16;
  if (rb % 16) {  // on the source's 16-byte grid
    const int o = (int)((uintptr_t)sr & 15);
    lo = max(lo - o, 0LL);
    hi = min(hi - o, rb);
  }
  ch.n = (int)(hi - lo);
  ch.d = dst[k] + at + lo;
  const char* sp = sr + lo;
  const uintptr_t al = (uintptr_t)ch.d | (uintptr_t)sp;
  ch.mode = ch.n <= 0 ? 0
                      : (ch.n == 16 && (al & 15) == 0 ? 1
                                                      : ((al & 3) == 0 ? 2
                                                                       : 3));
  hold_load(ch, sp);
}

// Block (x, y): rows [x * rows, x * rows + rows), chunks [y * slice, y *
// slice + slice) of each. Thread t copies the chunks c0 + t + 256 p (p <
// kHoldPos) of every held row: their leaves are found once (a binary
// search, then a forward walk), and its (held row, p) pairs are taken
// kHoldBatch at a time, their loads issued before their stores.
__global__ void __launch_bounds__(kHoldThreads)
    hold_kernel(HoldTable T, int leaves, const u8* __restrict__ live,
                long long F, int rows, int slice, int* sink) {
  __shared__ char* s_dst[kMaxLeaves];
  __shared__ const char* s_src[kMaxLeaves];
  __shared__ long long s_rb[kMaxLeaves];
  __shared__ int s_off[kMaxLeaves + 1];
  __shared__ int s_held[kHoldThreads];
  __shared__ int s_n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long f0 = (long long)blockIdx.x * rows;
  const bool held = t < rows && f0 + t < F && live[f0 + t] == 0;
  if (t == 0) s_n = 0;
  // the leaf table, a leaf a warp at a time: each read is the same for
  // the whole warp, so the parameter bank serves it at once
  for (int k = warp; k <= leaves; k += kHoldThreads / 32) {
    const int off = T.off[k];
    if (k < leaves) {
      char* d = T.dst[k];
      const char* sp = T.src[k];
      const long long rb = T.row_bytes[k];
      if (lane == 0) {
        s_dst[k] = d;
        s_src[k] = sp;
        s_rb[k] = rb;
      }
    }
    if (lane == 0) s_off[k] = off;
  }
  __syncthreads();
  if (held) s_held[atomicAdd(&s_n, 1)] = t;  // any order: rows are apart
  __syncthreads();
  const int c0 = blockIdx.y * slice + t;
  const int c1 = min(s_off[leaves], blockIdx.y * slice + slice);
  if (MT_K32_PART == 3 || s_n == 0 || c0 >= c1) return;
  const int n_pos = min(kHoldPos, (c1 - c0 + kHoldThreads - 1) /
                                      kHoldThreads);
  // the leaves of this thread's chunks
  int leaf[kHoldPos];
  int k = 0, hi = leaves;  // s_off[k] <= c0 < s_off[hi]
  while (hi - k > 1) {
    const int mid = (k + hi) >> 1;
    if (s_off[mid] <= c0)
      k = mid;
    else
      hi = mid;
  }
#pragma unroll
  for (int p = 0; p < kHoldPos; ++p) {
    const int c = c0 + p * kHoldThreads;
    if (p < n_pos)
      while (s_off[k + 1] <= c) ++k;
    leaf[p] = k;
  }
  int acc = 0;
  const int pairs = s_n * n_pos;
  for (int q0 = 0; q0 < pairs; q0 += kHoldBatch) {
    HoldChunk ch[kHoldBatch];
#pragma unroll
    for (int u = 0; u < kHoldBatch; ++u) {
      const int q = q0 + u;
      ch[u].mode = 0;
      ch[u].q = make_uint4(0, 0, 0, 0);
      if (q >= pairs) continue;
      const int h = q / n_pos, p = q - h * n_pos;
      // leaf[p] by a select, so the array stays in registers
      int kp = leaf[0];
#pragma unroll
      for (int i = 1; i < kHoldPos; ++i)
        if (p == i) kp = leaf[i];
      hold_chunk(ch[u], s_dst, s_src, s_rb, s_off, kp,
                 c0 + p * kHoldThreads, f0 + s_held[h]);
    }
#pragma unroll
    for (int u = 0; u < kHoldBatch; ++u) {
      if (MT_K32_PART == 1)
        acc += (int)(ch[u].q.x ^ ch[u].q.y ^ ch[u].q.z ^ ch[u].q.w);
      else
        hold_store(ch[u]);
    }
  }
  // the loads' words reach a store the compiler cannot drop
  if (MT_K32_PART == 1 && acc == 0x7fffffff && sink) *sink = acc;
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
//       leaves); ints: F, each leaf's bytes a cluster row, the plan
//       (hold_plan): the leaves' chunk offsets (leaves + 1 of them), rows
//       a block, chunks a block slice
MT_API int mt_fleet_hold(void* const* p, int n_ptrs, const long long* v,
                         int n_ints, void* stream) {
  const int leaves = (n_ptrs - 1) / 2;
  if (leaves < 1 || leaves > kMaxLeaves || n_ptrs != 1 + 2 * leaves ||
      n_ints != 2 * leaves + 4 || v[0] < 0)
    return cudaErrorInvalidValue;
  HoldTable T;
  const long long* off = v + 1 + leaves;
  const long long rows = v[2 + 2 * leaves], slice = v[3 + 2 * leaves];
  if (off[0] != 0 || rows < 1 || rows > kHoldThreads || slice < 1 ||
      slice > kHoldThreads * kHoldPos)
    return cudaErrorInvalidValue;
  T.off[0] = 0;
  for (int k = 0; k < leaves; ++k) {
    T.dst[k] = (char*)p[1 + 2 * k];
    T.src[k] = (const char*)p[2 + 2 * k];
    T.row_bytes[k] = v[1 + k];
    // the table must hold hold_chunks(row bytes) chunks a leaf
    if (T.row_bytes[k] < 0 || !T.dst[k] || !T.src[k] ||
        off[k + 1] - off[k] != hold_chunks(T.row_bytes[k]))
      return cudaErrorInvalidValue;
    T.off[k + 1] = (int)off[k + 1];
  }
  const long long C = off[leaves];
  // (held row, chunk) pairs of a block in int
  if (C > 0x7fffffffLL || rows * slice > 0x7fffffffLL - kHoldThreads *
                                             kHoldBatch)
    return cudaErrorInvalidValue;
  if (v[0] == 0) return cudaSuccess;
  const long long slices = C > 0 ? (C + slice - 1) / slice : 1;
  if (slices > 65535) return cudaErrorInvalidValue;
  const dim3 grid(mt_blocks(v[0], (int)rows), (unsigned)slices);
  hold_kernel<<<grid, kHoldThreads, 0, (cudaStream_t)stream>>>(
      T, leaves, (const u8*)p[0], v[0], (int)rows, (int)slice, nullptr);
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
