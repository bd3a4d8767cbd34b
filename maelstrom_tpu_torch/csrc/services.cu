// K20 tso_step, K21 seq_kv_step and K22 lww_kv_step: the role steps of the
// in-cluster services (maelstrom_tpu/nodes/services.py), with the pool
// round's freeze of killed and paused nodes fused.
//
// K20 replaces TSORole.step (services.py:106-115): a node's requests are
// the lanes with valid & type == T_TS; each request's rank is the
// exclusive prefix count over the inbox lanes, its reply carries
// a = ts + rank, and ts grows by the count. Every lane gets type = the
// reply code and b = c = 0 (lanes that are not requests keep them but
// are invalid); dest = src, reply_to = mid and the other fields are the
// inbox's own tensors, passed through by the caller. One block of one
// warp a node: a ballot and a popcount give each lane its rank, 32 lanes
// at a time with a running carry.
//
// K21 replaces SeqKVRole.step (services.py:138-168): the K lanes of a
// node apply in order over its kv row [keys] (a cas reads the key the
// lane before it wrote), so one thread walks them over a shared-memory
// copy of the row that the block loads and stores coalesced. Values are
// stored as value + 1, clipped to 0..255 after an int32 add that wraps
// (INT32_MAX + 1 clips to 0).
//
// K22 replaces LWWKVRole.step (services.py:199-274): one block a replica
// copies its kv, vts and dirty rows to shared memory, one thread walks
// the K lanes (merge adopts a strictly newer stamp; write and a cas that
// matches stamp the key with the clock as it stood before the lane; the
// clock moves after), then with gossip (G > 0: more than one replica) a
// block-wide prefix count over the dirty flags picks the first G dirty
// keys, which go out as T_MERGE lanes K..K+G-1 to the ring successor
// (base + (me + 1) % n) and leave the dirty set. Lanes past the picked
// keys are invalid with key, stamp and value 0.
//
// K21 and K22 write every field of their outbox as the plain versions
// build it (Msgs.empty: src, due, mid, b, c 0 and reply_to -1, except
// where a lane sets them). With the optional stall plane [n] a stalled
// node keeps its state rows and every lane of it is written invalid; the
// other fields are those of the unstalled step, as the JAX round's
// freeze leaves them. No kernel updates an input.
//
// Bound: bytes. K20 reads valid and type and writes five planes (~21
// bytes a lane); K21 and K22 read the inbox (37 bytes a lane), write the
// outbox (37 bytes a lane) and read and write the state rows (K21: 8
// bytes a key; K22: 18 bytes a key and 8 bytes a replica's clock). The
// lane walk is a few dozen integer operations a lane.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kKvThreads = 256;
constexpr int kWarps = kKvThreads / 32;

// --- K20 -------------------------------------------------------------------

struct TsoArgs {
  const u8* valid;  // inbox [n, K]
  const int* type;  // inbox [n, K]
  const int* ts;    // [n]
  const u8* stall;  // [n] or null
  u8* o_valid;      // outbox [n, K]
  int *o_type, *o_a, *o_b, *o_c;
  int* o_ts;        // [n]
};
constexpr int kTsoPtrs = sizeof(TsoArgs) / sizeof(void*);

__global__ void tso_kernel(TsoArgs A, int K, int t_req, int t_reply) {
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const unsigned ts = (unsigned)A.ts[n];
  unsigned carry = 0u;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const long long i = (long long)n * K + k;
    const bool req = k < K && A.valid[i] && A.type[i] == t_req;
    const unsigned ballot = __ballot_sync(0xffffffffu, req);
    if (k < K) {
      const unsigned rank = carry + __popc(ballot & ((1u << lane) - 1u));
      A.o_valid[i] = req && !stalled;
      A.o_type[i] = t_reply;
      A.o_a[i] = (int)(ts + rank);
      A.o_b[i] = 0;
      A.o_c[i] = 0;
    }
    carry += __popc(ballot);
  }
  if (lane == 0) A.o_ts[n] = stalled ? (int)ts : (int)(ts + carry);
}

// --- K21, K22 --------------------------------------------------------------

struct Inbox {
  const u8* valid;  // [n, K]
  const int *src, *dest, *due, *mid, *reply_to, *type, *a, *b, *c;
};
struct Outbox {
  u8* valid;        // [n, L]
  int *src, *dest, *due, *mid, *reply_to, *type, *a, *b, *c;
};

struct KvInts {
  int n, K, keys, G, base;
  int t_read, t_write, t_cas, t_merge, t_read_ok, t_write_ok, t_cas_ok,
      t_err;
};

struct SeqArgs {
  Inbox in;
  const int* kv;    // [n, keys]
  const u8* stall;  // [n] or null
  Outbox out;       // [n, K]
  int* o_kv;        // [n, keys]
};
constexpr int kSeqPtrs = sizeof(SeqArgs) / sizeof(void*);

struct LwwArgs {
  Inbox in;
  const int *kv, *vts;  // [n, keys]
  const u8* dirty;      // [n, keys]
  const int* clock;     // [n]
  const u8* stall;      // [n] or null
  Outbox out;           // [n, K + G]
  int *o_kv, *o_vts;
  u8* o_dirty;
  int* o_clock;
};
constexpr int kLwwPtrs = sizeof(LwwArgs) / sizeof(void*);

// clip(x + 1, 0, 0xFF) after an int32 add that wraps
__device__ __forceinline__ int plus1_byte(int x) {
  return mt_clip((int)((unsigned)x + 1u), 0, 0xFF);
}

// one reply lane of the KV tiers (services.py's _kv_reply)
__device__ __forceinline__ void kv_reply_lane(const Inbox& in, Outbox& out,
                                              long long i, long long o,
                                              const KvInts& I, int t,
                                              int cur, bool cas_ok,
                                              bool req, bool stalled) {
  int rtype, ra;
  if (t == I.t_read) {
    rtype = cur > 0 ? I.t_read_ok : I.t_err;
    ra = cur > 0 ? cur : 20;
  } else {
    rtype = t == I.t_write ? I.t_write_ok
                           : (cas_ok ? I.t_cas_ok : I.t_err);
    ra = (t == I.t_cas && !cas_ok) ? (cur > 0 ? 22 : 20) : 0;
  }
  out.valid[o] = req && !stalled;
  out.src[o] = 0;
  out.dest[o] = in.src[i];
  out.due[o] = 0;
  out.mid[o] = 0;
  out.reply_to[o] = in.mid[i];
  out.type[o] = rtype;
  out.a[o] = ra;
  out.b[o] = 0;
  out.c[o] = 0;
}

__global__ void seq_kv_kernel(SeqArgs A, KvInts I) {
  extern __shared__ int s_kv[];
  const int n = blockIdx.x;
  const long long row = (long long)n * I.keys;
  for (int j = threadIdx.x; j < I.keys; j += blockDim.x)
    s_kv[j] = A.kv[row + j];
  __syncthreads();
  const bool stalled = A.stall != nullptr && A.stall[n];
  if (threadIdx.x == 0) {
    for (int k = 0; k < I.K; ++k) {
      const long long i = (long long)n * I.K + k;
      const int t = A.in.type[i];
      const int key = mt_clip(A.in.a[i], 0, I.keys - 1);
      const bool req = A.in.valid[i] &&
                       (t == I.t_read || t == I.t_write || t == I.t_cas);
      const int cur = s_kv[key];
      const bool cas_ok =
          t == I.t_cas && cur > 0 && cur == plus1_byte(A.in.b[i]);
      if (req && (t == I.t_write || cas_ok))
        s_kv[key] = t == I.t_write ? plus1_byte(A.in.b[i])
                                   : plus1_byte(A.in.c[i]);
      kv_reply_lane(A.in, A.out, i, i, I, t, cur, cas_ok, req, stalled);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < I.keys; j += blockDim.x)
    A.o_kv[row + j] = stalled ? A.kv[row + j] : s_kv[j];
}

// exclusive prefix sum of `x` over the block (kKvThreads threads); the
// block's total in *total. Every thread calls it.
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is reused by the next call
  return before + v - x;
}

__global__ void lww_kv_kernel(LwwArgs A, KvInts I) {
  extern __shared__ int smem[];
  int* s_kv = smem;
  int* s_vts = s_kv + I.keys;
  int* s_pick = s_vts + I.keys;                 // [G] key of gossip lane
  u8* s_dirty = (u8*)(s_pick + (I.G > 0 ? I.G : 1));
  __shared__ int s_warp[kWarps];
  const int n = blockIdx.x;
  const long long row = (long long)n * I.keys;
  for (int j = threadIdx.x; j < I.keys; j += blockDim.x) {
    s_kv[j] = A.kv[row + j];
    s_vts[j] = A.vts[row + j];
    s_dirty[j] = A.dirty[row + j];
  }
  for (int j = threadIdx.x; j < I.G; j += blockDim.x) s_pick[j] = -1;
  __syncthreads();
  const bool stalled = A.stall != nullptr && A.stall[n];
  const int L = I.K + I.G;
  if (threadIdx.x == 0) {
    int clock = A.clock[n];
    for (int k = 0; k < I.K; ++k) {
      const long long i = (long long)n * I.K + k;
      const long long o = (long long)n * L + k;
      const bool valid = A.in.valid[i];
      const int t = A.in.type[i], b = A.in.b[i], c = A.in.c[i];
      const int key = mt_clip(A.in.a[i], 0, I.keys - 1);
      const int cur = s_kv[key], kts = s_vts[key];
      const bool mg = valid && t == I.t_merge;
      const bool adopt = mg && b > kts;
      const bool cas_ok =
          valid && t == I.t_cas && cur > 0 && cur == plus1_byte(b);
      const bool wr = valid && (t == I.t_write || cas_ok);
      if (adopt || wr) {
        s_kv[key] = adopt ? c
                          : (t == I.t_write ? plus1_byte(b) : plus1_byte(c));
        s_vts[key] = adopt ? b : clock;
        s_dirty[key] = 1;
      }
      if (wr) {
        clock = (int)((unsigned)clock + 1u);
      } else {
        const int m = mg ? (int)((unsigned)b + 1u) : 0;
        clock = clock > m ? clock : m;
      }
      const bool req =
          valid && (t == I.t_read || t == I.t_write || t == I.t_cas);
      kv_reply_lane(A.in, A.out, i, o, I, t, cur, cas_ok, req, stalled);
    }
    A.o_clock[n] = stalled ? A.clock[n] : clock;
  }
  __syncthreads();
  if (I.G > 0) {
    // the first G dirty keys by prefix count, chunk by chunk
    int carry = 0;
    for (int j0 = 0; j0 < I.keys; j0 += kKvThreads) {
      const int j = j0 + threadIdx.x;
      const int flag = j < I.keys && s_dirty[j];
      int total;
      const int rank = carry + block_exclusive_scan(flag, s_warp, &total);
      if (flag && rank < I.G) {
        s_pick[rank] = j;
        s_dirty[j] = 0;
      }
      carry += total;
    }
    __syncthreads();
    const int succ = I.base + (n + 1) % I.n;
    for (int g = threadIdx.x; g < I.G; g += blockDim.x) {
      const long long o = (long long)n * L + I.K + g;
      const int j = s_pick[g];
      A.out.valid[o] = j >= 0 && !stalled;
      A.out.src[o] = 0;
      A.out.dest[o] = succ;
      A.out.due[o] = 0;
      A.out.mid[o] = 0;
      A.out.reply_to[o] = -1;
      A.out.type[o] = I.t_merge;
      A.out.a[o] = j >= 0 ? j : 0;
      A.out.b[o] = j >= 0 ? s_vts[j] : 0;
      A.out.c[o] = j >= 0 ? s_kv[j] : 0;
    }
  }
  for (int j = threadIdx.x; j < I.keys; j += blockDim.x) {
    A.o_kv[row + j] = stalled ? A.kv[row + j] : s_kv[j];
    A.o_vts[row + j] = stalled ? A.vts[row + j] : s_vts[j];
    A.o_dirty[row + j] = stalled ? A.dirty[row + j] : s_dirty[j];
  }
}

bool read_kv_ints(const long long* v, KvInts* I) {
  int* f = (int*)I;
  for (int j = 0; j < (int)(sizeof(KvInts) / sizeof(int)); ++j)
    f[j] = (int)v[j];
  return I->n >= 1 && I->K >= 1 && I->keys >= 1 && I->G >= 0;
}

size_t lww_smem(const KvInts& I) {
  return (size_t)(2 * I.keys + (I.G > 0 ? I.G : 1)) * sizeof(int) +
         (size_t)I.keys;
}

}  // namespace

// ptrs: the fields of TsoArgs in order (stall may be null)
// ints: n, K, the request type code, the reply type code
MT_API int mt_tso_step(void* const* p, int n_ptrs, const long long* v,
                       int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kTsoPtrs, n_ints, 4)) return cudaErrorInvalidValue;
  TsoArgs A;
  memcpy(&A, p, sizeof(A));
  const int n = (int)v[0], K = (int)v[1];
  if (n < 1 || K < 1) return cudaErrorInvalidValue;
  tso_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(A, K, (int)v[2],
                                                 (int)v[3]);
  return cudaGetLastError();
}

constexpr int kKvInts = sizeof(KvInts) / sizeof(int);

// ptrs: the inbox's ten fields (valid, src, dest, due, mid, reply_to,
//       type, a, b, c), kv, stall (or null), the outbox's ten fields, o_kv
// ints: n, K, keys, G (0), base (0), then the wire codes read, write, cas,
//       merge, read_ok, write_ok, cas_ok, err (KvInts)
MT_API int mt_seq_kv_step(void* const* p, int n_ptrs, const long long* v,
                          int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kSeqPtrs, n_ints, kKvInts))
    return cudaErrorInvalidValue;
  SeqArgs A;
  memcpy(&A, p, sizeof(A));
  KvInts I;
  if (!read_kv_ints(v, &I) || I.G != 0) return cudaErrorInvalidValue;
  seq_kv_kernel<<<I.n, kKvThreads, I.keys * sizeof(int),
                  (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}

// ptrs: the inbox's ten fields, kv, vts, dirty, clock, stall (or null), the
//       outbox's ten fields ([n, K + G]), o_kv, o_vts, o_dirty, o_clock
// ints: n, K, keys, G (the gossip lanes: 0 for a single replica), base
//       (the global id of replica 0), then the wire codes (KvInts)
MT_API int mt_lww_kv_step(void* const* p, int n_ptrs, const long long* v,
                          int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kLwwPtrs, n_ints, kKvInts))
    return cudaErrorInvalidValue;
  LwwArgs A;
  memcpy(&A, p, sizeof(A));
  KvInts I;
  if (!read_kv_ints(v, &I)) return cudaErrorInvalidValue;
  const size_t smem = lww_smem(I);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  lww_kv_kernel<<<I.n, kKvThreads, smem, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}
