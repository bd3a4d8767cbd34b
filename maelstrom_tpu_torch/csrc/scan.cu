// K5 reply_log_append and K6 quiet_probe: the device half of the scan-ahead
// loop and of the runner's quiescence probe.
//
// K5 replaces append_replies in maelstrom_tpu/sim.py:_build_scan_fn
// (:821-837, with BroadcastProgram.reply_payload and _pack_seen_words,
// maelstrom_tpu/nodes/broadcast.py:338-351) and the scan's exit condition
// `cond` (:839-845). One launch (two past 4096 rows) takes a round's
// client messages cm [CW] and
//   - writes each valid row's ten Msgs fields at rn + (valid rows before
//     it) of the reply log [rcap], dropping positions >= rcap as JAX's
//     mode="drop" scatter does;
//   - writes the row's round stamp (the post-round counter, read on the
//     device) and its payload: the W = n_windows * 2 words packing
//     seen[clip(src, 0, N - 1)], 32 values a word, low bit first, bit 31
//     kept as the sign as JAX's int32 sums keep it;
//   - writes rn + (every valid row) into rn_out, and the scan's exit
//     flag: go = k < k_max & ~(stop & any valid) & rn_out + CW <= rcap;
//     where go fails, exit_k takes k unless an earlier round already set
//     it. The host reads exit_k once a chunk of rounds.
// JAX gathers a payload for all CW rows and drops the invalid ones; this
// touches only the valid rows. The int32 form (mt_reply_log_append_i32,
// for PnCounterProgram.reply_payload, maelstrom_tpu/nodes/pn_counter.py
// :211-214: reply_payload_words = 1) copies the row rows[clip(src)] of an
// [N, W] int32 plane (`seen` points at it, V = W) as the payload instead
// of packing bits.
//
// Bound: CW valid bytes read once, plus (41 + 4 W + V) bytes for each
// valid row; the main path's rounds carry few replies, so it is bound by
// the valid-byte read and by launch latency. Design: segments of kSeg
// rows, as K4. Up to kSeg rows one block walks the rows a tile of
// kThreads at a time, ranking them with warp ballots (no count launch);
// past kSeg a count launch writes each segment's valid count and every
// emit block sums the counts before its segment. Blocks whose segment
// holds no valid row leave at once, except the last, which writes rn_out
// and the flag. rn is double-buffered (rn_in read by every block, rn_out
// written once), so no block can read a half-updated counter.
//
// K6 replaces the jitted _quiet in maelstrom_tpu/runner/tpu_runner.py
// (:2048) with BroadcastProgram.quiescent (nodes/broadcast.py:332-336):
// quiet = no byte set in any of up to kMaxPlanes bool planes (the flight
// pool's valid, the channels' valid, the program's pending / inflight /
// inflight_old). A pure reduction, bound by bytes: 16-byte loads over
// each plane's aligned body, a block-wide OR, and one byte store by every
// block that saw a set byte (all store 0 into the flag the wrapper set to
// 1, so their order does not matter).
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16 * kThreads;  // rows a block
constexpr int kMaxPlanes = 8;

struct AppendArgs {
  MtReplyCols cols;      // cm [CW], the log [rcap], seen [N, V]
  const int* round_ptr;  // post-round counter: the stamp
  const int* rn_in;
  int* rn_out;
  int* exit_k;
  int* seg_count;  // scratch [n_segments] (used past kSeg rows)
};
constexpr int kAppendPtrs = sizeof(AppendArgs) / sizeof(void*);

struct AppendInts {
  long long CW;
  int rcap, W, N, V, k, k_max, stop, n_seg;
};

__device__ int block_sum(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__global__ void count_kernel(const u8* __restrict__ valid,
                             int* __restrict__ seg_count, long long n) {
  __shared__ int red[kWarps];
  const long long lo = (long long)blockIdx.x * kSeg;
  int cnt = 0;
  for (long long i = lo + threadIdx.x; i < lo + kSeg && i < n;
       i += kThreads)
    cnt += valid[i] != 0;
  cnt = block_sum(cnt, red);
  if (threadIdx.x == 0) seg_count[blockIdx.x] = cnt;
}

template <bool kRows>
__global__ void append_kernel(AppendArgs A, AppendInts I) {
  __shared__ int red[kWarps];
  __shared__ int warp_base[kWarps];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const bool last = b == I.n_seg - 1;
  int before = 0;
  if (I.n_seg > 1) {
    for (int s = t; s < b; s += kThreads) before += A.seg_count[s];
    before = block_sum(before, red);
    if (A.seg_count[b] == 0 && !last) return;  // uniform across the block
  }
  const int rn = *A.rn_in;
  const long long lo = (long long)b * kSeg;
  const long long hi = lo + kSeg < I.CW ? lo + kSeg : I.CW;
  const long long vr = before + mt_rank_valid<kThreads>(
      A.cols.valid, lo, hi, warp_base, [&](long long i, long long r) {
        const long long pos = rn + before + r;
        if (pos < I.rcap)
          mt_write_reply_row<kRows>(A.cols, i, pos, *A.round_ptr, 0, I.N,
                                    I.W, I.V);
      });
  if (last && t == 0) {
    const long long total = vr;  // every valid row of cm
    const long long rn2 = rn + total;
    *A.rn_out = (int)rn2;
    const bool go =
        I.k < I.k_max && !(I.stop && total > 0) && rn2 + I.CW <= I.rcap;
    if (!go && *A.exit_k > I.k) *A.exit_k = I.k;
  }
}

struct Planes {
  const u8* ptr[kMaxPlanes];
  long long n[kMaxPlanes];
  int count;
};

__global__ void quiet_kernel(Planes P, u8* __restrict__ quiet) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  bool busy = false;
  for (int k = 0; k < P.count; ++k) {
    const u8* p = P.ptr[k];
    const long long n = P.n[k];
    long long head = (long long)((16 - ((uintptr_t)p & 15)) & 15);
    if (head > n) head = n;
    for (long long i = tid; i < head; i += nth) busy |= p[i] != 0;
    const uint4* q = reinterpret_cast<const uint4*>(p + head);
    const long long n16 = (n - head) / 16;
    for (long long i = tid; i < n16; i += nth) {
      const uint4 x = q[i];
      busy |= (x.x | x.y | x.z | x.w) != 0u;
    }
    for (long long i = head + n16 * 16 + tid; i < n; i += nth)
      busy |= p[i] != 0;
  }
  if (__syncthreads_or(busy) && threadIdx.x == 0) *quiet = 0;
}

template <bool kRows>
int reply_log_append(void* const* p, int n_ptrs, const long long* v,
                     int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kAppendPtrs, n_ints, 9))
    return cudaErrorInvalidValue;
  AppendArgs A;
  memcpy(&A, p, sizeof(A));
  AppendInts I;
  I.CW = v[0];
  I.rcap = (int)v[1];
  I.W = (int)v[2];
  I.N = (int)v[3];
  I.V = (int)v[4];
  I.k = (int)v[5];
  I.k_max = (int)v[6];
  I.stop = (int)v[7];
  I.n_seg = (int)((I.CW + kSeg - 1) / kSeg);
  if (I.CW < 1 || (I.n_seg > 1 && I.n_seg > v[8]) || I.rcap < 1 ||
      A.cols.l_valid == nullptr ||
      (I.W > 0 && (A.cols.l_plog == nullptr || A.cols.seen == nullptr)) ||
      (kRows && I.V != I.W))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (I.n_seg > 1) {
    count_kernel<<<I.n_seg, kThreads, 0, st>>>(A.cols.valid, A.seg_count, I.CW);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  append_kernel<kRows><<<I.n_seg, kThreads, 0, st>>>(A, I);
  return cudaGetLastError();
}

}  // namespace

// ptrs: the fields of AppendArgs in order
// ints: CW, rcap (>= 1), W, N, V, k, k_max, stop, and the
//       length of the seg_count scratch (ceil(CW / 4096) entries needed
//       past 4096 rows)
MT_API int mt_reply_log_append(void* const* p, int n_ptrs,
                               const long long* v, int n_ints,
                               void* stream) {
  return reply_log_append<false>(p, n_ptrs, v, n_ints, stream);
}

// as mt_reply_log_append, with `seen` an [N, W] int32 plane and V = W
MT_API int mt_reply_log_append_i32(void* const* p, int n_ptrs,
                                   const long long* v, int n_ints,
                                   void* stream) {
  return reply_log_append<true>(p, n_ptrs, v, n_ints, stream);
}

// ptrs: the bool planes (1 to 8), then the quiet flag (a bool the caller
//       set to 1)
// ints: each plane's length in bytes, in the same order
MT_API int mt_quiet_probe(void* const* p, int n_ptrs, const long long* v,
                          int n_ints, void* stream) {
  const int count = n_ptrs - 1;
  if (count < 1 || count > kMaxPlanes || n_ints != count)
    return cudaErrorInvalidValue;
  Planes P;
  long long total = 0;
  for (int k = 0; k < count; ++k) {
    P.ptr[k] = (const u8*)p[k];
    P.n[k] = v[k];
    total += v[k];
  }
  P.count = count;
  long long blocks = (total / 16 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  quiet_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      P, (u8*)p[count]);
  return cudaGetLastError();
}
