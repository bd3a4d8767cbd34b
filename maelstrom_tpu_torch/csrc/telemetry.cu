// K19 ring_update: one round's fold of the flight recorder's metric ring.
//
// Replaces ring_update in maelstrom_tpu/telemetry.py (:130-216), which the
// JAX round calls at its end (maelstrom_tpu/sim.py:446-457 on the pool
// path, :645-659 on the edge path). All int32, sums wrapping as XLA's do
// (unsigned arithmetic here). Two launches, since the per-client pass
// needs every reply hit of the round first:
//
//   pass 1 (grid-stride over every input row):
//     - counts the flight pool's valid rows and the channels' valid
//       cells (block reductions, one global atomic a block);
//     - per role slice [lo, hi): the valid cells of rows lo..hi-1 of the
//       one or two send planes [N, W] (the outbox valid plane, or the
//       edge sends and the uncompacted reply rows), so the per-node send
//       counts are never written out;
//     - marks hit[c] for every valid reply row to a client (dest >= N, c
//       = min(dest - N, C - 1)): a store of 1, so duplicated replies
//       count once in any order;
//     - adds round + 1 into armed[c] for every valid invoke row (src >=
//       N): two invokes of one client in one round add, as JAX's
//       scatter-add does;
//     - block 0 writes the four stat deltas, rounds + 1, and copies the
//       latency histogram, count and sum into the outputs (pass 2 adds
//       to them).
//   pass 2 (one thread a client):
//     - the latency against the PRE-arm req_round, its bucket (the bit
//       length of lat - 1, clipped to 15: JAX's float32 ceil(log2(lat))
//       on 1..2^20, and both clip past 2^15), a shared histogram, then
//       one global atomic a bucket, count and sum;
//     - the new req_round (armed - 1 where armed, -1 where a reply came
//       and no invoke);
//     - block 0 finishes the occupancy histograms and maxima ((occ * 8)
//       floor-divided by the capacity, in int32) and the role sums.
// Every output is a fresh tensor; the ring it reads is left as it was.
//
// Bound: bytes. The pool and channel valid planes, the send planes and
// the reply/inject rows are read once (one byte a bool, four an int32),
// the ring's C-wide req_round read and written; a few integer operations
// a byte. At the main path's shapes the planes are some kilobytes to a
// few megabytes: launch latency dominates the small ones.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRoles = 32;
constexpr int kOcc = 8;
constexpr int kLat = 16;

// MetricRing's fields in order
enum { kRounds, kSent, kDelivered, kDropped, kDuplicated, kPoolHist,
       kPoolMax, kChanHist, kChanMax, kRoleSent, kLatHist, kLatCount,
       kLatSum, kReqRound, kFields };
// NetStats fields passed in order
enum { kSentAll, kRecvAll, kLost, kDropPart, kDropDown, kDropOver, kDup,
       kStats };

struct Args {
  const u8 *pool, *chan, *plane0, *plane1, *rep_valid;
  const int* rep_dest;
  const u8* inj_valid;
  const int *inj_src, *round;
  int* scratch;  // [2 + R + 2 C]: pool count, channel count, roles, hit, armed
  const int* st0[kStats];
  const int* st1[kStats];
  const int* in[kFields];
  int* out[kFields];
  long long P, CH, W0, W1, RP, Q;
  int N, C, pool_cap, R;
  int lo[kMaxRoles], hi[kMaxRoles];
};

__device__ __forceinline__ int block_total(int x) {
  __shared__ int s;
  if (threadIdx.x == 0) s = 0;
  __syncthreads();
  const int w = __reduce_add_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0 && w) atomicAdd(&s, w);
  __syncthreads();
  const int t = s;
  __syncthreads();
  return t;
}

__device__ __forceinline__ int count_valid(const u8* p, long long from,
                                           long long to) {
  int c = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = from + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < to; i += stride)
    c += p[i] != 0;
  return c;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__global__ void ring_pass1(Args a) {
  int* const roles = a.scratch + 2;
  int* const hit = a.scratch + 2 + a.R;
  int* const armed = hit + a.C;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  int t = block_total(count_valid(a.pool, 0, a.P));
  if (threadIdx.x == 0 && t) atomicAdd(&a.scratch[0], t);
  if (a.chan != nullptr) {
    t = block_total(count_valid(a.chan, 0, a.CH));
    if (threadIdx.x == 0 && t) atomicAdd(&a.scratch[1], t);
  }
  for (int r = 0; r < a.R; ++r) {
    int c = count_valid(a.plane0, a.lo[r] * a.W0, a.hi[r] * a.W0);
    if (a.plane1 != nullptr)
      c += count_valid(a.plane1, a.lo[r] * a.W1, a.hi[r] * a.W1);
    t = block_total(c);
    if (threadIdx.x == 0 && t) atomicAdd(&roles[r], t);
  }
  for (long long i = tid; i < a.RP; i += stride) {
    const int d = a.rep_dest[i];
    if (a.rep_valid[i] && d >= a.N) hit[min(d - a.N, a.C - 1)] = 1;
  }
  const int arm = wrap_add(*a.round, 1);
  for (long long i = tid; i < a.Q; i += stride) {
    const int s = a.inj_src[i];
    if (a.inj_valid[i] && s >= a.N)
      atomicAdd(&armed[mt_clip(s - a.N, 0, a.C - 1)], arm);
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x < kLat)
      a.out[kLatHist][threadIdx.x] = a.in[kLatHist][threadIdx.x];
    if (threadIdx.x == 0) {
      auto d = [&](int f) { return wrap_sub(*a.st1[f], *a.st0[f]); };
      *a.out[kRounds] = wrap_add(*a.in[kRounds], 1);
      *a.out[kSent] = wrap_add(*a.in[kSent], d(kSentAll));
      *a.out[kDelivered] = wrap_add(*a.in[kDelivered], d(kRecvAll));
      *a.out[kDropped] = wrap_add(
          *a.in[kDropped],
          wrap_add(wrap_add(d(kLost), d(kDropPart)),
                   wrap_add(d(kDropDown), d(kDropOver))));
      *a.out[kDuplicated] = wrap_add(*a.in[kDuplicated], d(kDup));
      *a.out[kLatCount] = *a.in[kLatCount];
      *a.out[kLatSum] = *a.in[kLatSum];
    }
  }
}

__device__ __forceinline__ int occ_bucket(int occ, int cap) {
  const int x = (int)((unsigned)occ * (unsigned)kOcc);
  const int m = cap > 1 ? cap : 1;
  int q = x / m;
  if ((x % m != 0) && (x < 0)) --q;  // floor division (m > 0)
  return mt_clip(q, 0, kOcc - 1);
}

__global__ void ring_pass2(Args a) {
  __shared__ int s_hist[kLat];
  const int* const hit = a.scratch + 2 + a.R;
  const int* const armed = hit + a.C;
  if (threadIdx.x < kLat) s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  int cnt = 0, sum = 0;
  if (c < a.C) {
    const bool h = hit[c] != 0;
    const int req0 = a.in[kReqRound][c];
    const int lat = (h && req0 >= 0) ? wrap_sub(*a.round, req0) : -1;
    if (lat >= 0) {
      const int b = lat <= 1 ? 0 : min(32 - __clz(lat - 1), kLat - 1);
      atomicAdd(&s_hist[b], 1);
      cnt = 1;
      sum = lat;
    }
    const int arm = armed[c];
    int req = arm > 0 ? arm - 1 : req0;
    if (h && !(arm > 0)) req = -1;
    a.out[kReqRound][c] = req;
  }
  cnt = block_total(cnt);
  sum = block_total(sum);  // wraps as an int32 sum
  if (threadIdx.x == 0) {
    if (cnt) atomicAdd(a.out[kLatCount], cnt);
    if (sum) atomicAdd((unsigned*)a.out[kLatSum], (unsigned)sum);
  }
  if (threadIdx.x < kLat && s_hist[threadIdx.x])
    atomicAdd(&a.out[kLatHist][threadIdx.x], s_hist[threadIdx.x]);

  if (blockIdx.x == 0) {
    const int pool_occ = a.scratch[0];
    const int chan_occ = a.scratch[1];
    const int pb = occ_bucket(pool_occ, a.pool_cap);
    const int cb = a.chan != nullptr ? occ_bucket(chan_occ, (int)a.CH) : -1;
    if (threadIdx.x < kOcc) {
      const int i = threadIdx.x;
      a.out[kPoolHist][i] = wrap_add(a.in[kPoolHist][i], i == pb);
      a.out[kChanHist][i] = wrap_add(a.in[kChanHist][i], i == cb);
    }
    if (threadIdx.x < a.R)
      a.out[kRoleSent][threadIdx.x] =
          wrap_add(a.in[kRoleSent][threadIdx.x], a.scratch[2 + threadIdx.x]);
    if (threadIdx.x == 0) {
      *a.out[kPoolMax] = max(*a.in[kPoolMax], pool_occ);
      *a.out[kChanMax] = a.chan != nullptr ? max(*a.in[kChanMax], chan_occ)
                                           : *a.in[kChanMax];
    }
  }
}

}  // namespace

// ptrs: pool valid [P], channel valid [CH] (null without channels), send
//       plane 0 [N, W0], send plane 1 [N, W1] (or null), reply valid
//       [RP], reply dest [RP], inject valid [Q], inject src [Q], the
//       round-entry counter, scratch [2 + R + 2 C] (zeroed), the round-entry
//       NetStats sent_all, recv_all, lost, dropped_partition,
//       dropped_down, dropped_overflow, duplicated, the same seven after
//       the round, the ring's 14 fields, the output ring's 14 fields
// ints: P, CH, W0, W1, RP, Q, N, C, pool_cap, R, then lo_0, hi_0, ...,
//       lo_{R-1}, hi_{R-1}
MT_API int mt_ring_update(void* const* p, int n_ptrs, const long long* v,
                          int n_ints, void* stream) {
  constexpr int kPtrs = 10 + 2 * kStats + 2 * kFields;
  if (n_ptrs != kPtrs || n_ints < 10) return cudaErrorInvalidValue;
  Args a;
  a.pool = (const u8*)p[0];
  a.chan = (const u8*)p[1];
  a.plane0 = (const u8*)p[2];
  a.plane1 = (const u8*)p[3];
  a.rep_valid = (const u8*)p[4];
  a.rep_dest = (const int*)p[5];
  a.inj_valid = (const u8*)p[6];
  a.inj_src = (const int*)p[7];
  a.round = (const int*)p[8];
  a.scratch = (int*)p[9];
  for (int i = 0; i < kStats; ++i) {
    a.st0[i] = (const int*)p[10 + i];
    a.st1[i] = (const int*)p[10 + kStats + i];
  }
  for (int i = 0; i < kFields; ++i) {
    a.in[i] = (const int*)p[10 + 2 * kStats + i];
    a.out[i] = (int*)p[10 + 2 * kStats + kFields + i];
  }
  a.P = v[0];
  a.CH = v[1];
  a.W0 = v[2];
  a.W1 = v[3];
  a.RP = v[4];
  a.Q = v[5];
  a.N = (int)v[6];
  a.C = (int)v[7];
  a.pool_cap = (int)v[8];
  a.R = (int)v[9];
  if (a.R < 1 || a.R > kMaxRoles || n_ints != 10 + 2 * a.R || a.C < 1 ||
      a.plane0 == nullptr)
    return cudaErrorInvalidValue;
  for (int r = 0; r < a.R; ++r) {
    a.lo[r] = (int)v[10 + 2 * r];
    a.hi[r] = (int)v[11 + 2 * r];
  }
  const long long work = a.P + a.CH + a.N * (a.W0 + a.W1) + a.RP + a.Q;
  long long blocks = (work / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  cudaStream_t s = (cudaStream_t)stream;
  ring_pass1<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ring_pass2<<<mt_blocks(a.C, kThreads), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}
