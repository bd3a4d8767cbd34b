// K23 compartment_sequencer_step, K24 compartment_proxy_step, K25
// compartment_acceptor_step and K26 compartment_replica_step: the role
// steps of compartmentalized consensus with one sequencer
// (maelstrom_tpu/nodes/compartment.py), with the pool round's freeze of
// killed and paused nodes fused.
//
// K23 replaces SequencerRole._step_stable (compartment.py:465-518). One
// block a node, one thread a table row and an inbox lane (thread t is row
// t and lane t). T_DONE lanes retire the rows holding their slot; block
// prefix counts give each free row its rank, each client request its
// want rank and each request that found a row its ok rank; the request
// of ok rank r takes slot next_slot + r and is done when that slot is
// under the log's capacity C (only done requests fill rows: an ok request
// past C leaves its row free and sheds). Fresh rows get t_last = round -
// retry, so they are due this round. Lanes [0, Q) resend T_ASSIGN for the
// rows due on the retry tick; lanes [Q, Q + K) shed (error 11).
//
// K24 replaces ProxyRole.step at one sequencer (compartment.py:877-1060
// without the ballot and conviction branches). One block a proxy, one
// thread a table row and an inbox lane, the [Q, AR] ack flags in shared
// memory. In JAX's order: P2B and EXEC acks fold onto the rows (ack j is
// lane b == j), rows whose R replicas all acked retire (T_DONE lanes
// [Q * AR, Q * AR + Q)), a row whose acks cover a whole grid row is
// chosen (learn, acks cleared, due now), then T_ASSIGN lanes are deduped
// by slot (the first per slot; slots held by a live row drop) and fill
// free rows by rank. Last the fan lanes [q * AR + j]: T_P2A to acceptor j
// < A or T_LEARN to replica j < R, for the rows due on the retry tick.
//
// K25 replaces AcceptorRole._step_stable (compartment.py:1095-1113). A
// grid of blocks over (node, slot chunk) copies the acc_cmd and acc_has
// rows out of place (16 bytes a thread where the rows allow); after the
// copy each block writes the deduped T_P2A lanes whose slot lies in its
// chunk. The chunk-0 block writes the T_P2B ack lanes.
//
// K26 replaces ReplicaRole.step (compartment.py:1238-1322). The same grid
// copies the r_cmd, r_client, r_mid and r_has rows out of place and
// scatters the deduped T_LEARN lanes after the copy of their chunk; one
// more block a node writes the T_EXEC acks (lanes [AP, AP + K)) and walks
// the AP in-order applies with one thread over the node's kv row in
// shared memory: it reads each slot through the learned lanes over the
// input rows, so a slot learned this round may apply this round, and a
// cas reads the previous apply's write. A command's key past the row
// reads JAX's gather fill (INT32_MIN) and writes nothing.
//
// Every kernel writes every field of its outbox as the plain versions
// build it (Msgs.empty: src, due, mid, b, c 0 and reply_to -1, except
// where a lane sets them). With the optional stall plane [n] a stalled
// node keeps its state rows and every lane of it is written invalid; the
// other fields are those of the unstalled step, as the JAX round's freeze
// leaves them. No kernel updates an input. int32 adds, subtractions and
// shifts wrap (unsigned arithmetic), as XLA's do.
//
// Bound: bytes. K23 and K24 read and write their [n, Q] tables and the
// inbox and write the outbox, a few dozen integer operations a row and a
// lane (K24's ack fold Q x K x AR); K25 and K26 read and write their
// [n, C] rows (K25 5 bytes a slot, K26 13), which dominate at a full-size
// log.
#include <cstring>

#include "common.cuh"

namespace {

// --- shared pieces ---------------------------------------------------------

struct Lanes {       // the inbox fields the kernels read, [n, K]
  const u8* valid;
  const int *src, *mid, *type, *a, *b, *c;
};
struct Outbox {      // [n, L]
  u8* valid;
  int *src, *dest, *due, *mid, *reply_to, *type, *a, *b, *c;
};

__device__ __forceinline__ void put_lane(const Outbox& o, long long i,
                                         bool valid, int dest, int type,
                                         int a, int b, int c,
                                         int reply_to) {
  o.valid[i] = valid;
  o.src[i] = 0;
  o.dest[i] = dest;
  o.due[i] = 0;
  o.mid[i] = 0;
  o.reply_to[i] = reply_to;
  o.type[i] = type;
  o.a[i] = a;
  o.b[i] = b;
  o.c[i] = c;
}

__device__ __forceinline__ int wadd(int x, int y) {
  return (int)((unsigned)x + (unsigned)y);
}
__device__ __forceinline__ int wsub(int x, int y) {
  return (int)((unsigned)x - (unsigned)y);
}
__device__ __forceinline__ int shl16(int x) {
  return (int)((unsigned)x << 16);
}

// exclusive prefix sum of x over the block (blockDim.x a multiple of 32,
// at most 1,024); the block's total in *total. Every thread calls it.
__device__ __forceinline__ int block_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) s_warp[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp is reused by the next call
  return before + v - x;
}

int block_threads(int rows) { return ((rows + 31) / 32) * 32; }

// --- K23 -------------------------------------------------------------------

struct SeqArgs {
  Lanes in;
  const int* next_slot;  // [n]
  const u8* t_valid;     // [n, Q]
  const int *t_slot, *t_cmd, *t_client, *t_mid, *t_last;
  const int* round;      // [1]
  const u8* stall;       // [n] or null
  Outbox out;            // [n, Q + K]
  int* o_next_slot;
  u8* o_t_valid;
  int *o_t_slot, *o_t_cmd, *o_t_client, *o_t_mid, *o_t_last;
};
constexpr int kSeqPtrs = sizeof(SeqArgs) / sizeof(void*);

struct SeqInts {
  int n, K, Q, C, keys, n_nodes, p_base, P, retry;
};

// wire codes (compartment.py, raft.py)
constexpr int T_ERR = 1, T_READ = 10, T_READ_OK = 11, T_WRITE = 12,
              T_WRITE_OK = 13, T_CAS = 14, T_CAS_OK = 15, T_ASSIGN = 30,
              T_P2A = 31, T_P2B = 32, T_LEARN = 33, T_EXEC = 34,
              T_DONE = 35, E_UNAVAILABLE = 11;
constexpr int OP_NOOP = 0, OP_WRITE = 1, OP_CAS = 2, OP_READ = 3;

__global__ void seq_kernel(SeqArgs A, SeqInts I) {
  extern __shared__ int sm[];
  const int K = I.K, Q = I.Q;
  int* l_a = sm;                  // [K] the T_DONE lanes' slot
  int* l_slot = l_a + K;          // [K] a done request's row values
  int* l_cmd = l_slot + K;
  int* l_client = l_cmd + K;
  int* l_mid = l_client + K;
  int* s_rbr = l_mid + K;         // [Q] row by free rank
  int* s_asg = s_rbr + Q;         // [Q] the lane filling the row, or -1
  u8* l_done = (u8*)(s_asg + Q);  // [K]
  __shared__ int s_warp[32];
  const int n = blockIdx.x, t = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const int rnd = A.round[0];
  const int L = Q + K;

  const long long r = (long long)n * Q + t;
  bool tv = false;
  int ts = 0, tc = 0, tcl = 0, tm = 0, tl = 0;
  if (t < Q) {
    tv = A.t_valid[r];
    ts = A.t_slot[r];
    tc = A.t_cmd[r];
    tcl = A.t_client[r];
    tm = A.t_mid[r];
    tl = A.t_last[r];
    s_rbr[t] = 0;
    s_asg[t] = -1;
  }
  const long long i = (long long)n * K + t;
  bool lv = false;
  int ltype = 0, la = 0, lb = 0, lc = 0, lsrc = 0, lmid = 0;
  if (t < K) {
    lv = A.in.valid[i];
    ltype = A.in.type[i];
    la = A.in.a[i];
    lb = A.in.b[i];
    lc = A.in.c[i];
    lsrc = A.in.src[i];
    lmid = A.in.mid[i];
    l_done[t] = lv && ltype == T_DONE;
    l_a[t] = la;
  }
  __syncthreads();

  // T_DONE: the command executed everywhere — retire its row
  if (t < Q && tv) {
    for (int k = 0; k < K; ++k)
      if (l_done[k] && l_a[k] == ts) {
        tv = false;
        break;
      }
  }
  // free rows by rank
  const int is_free = (t < Q && !tv) ? 1 : 0;
  int n_free;
  const int free_rank = block_scan(is_free, s_warp, &n_free);
  if (is_free) s_rbr[free_rank] = t;
  // client requests -> rows by rank, then slots
  const bool creq =
      t < K && lv && (ltype == T_READ || ltype == T_WRITE || ltype == T_CAS);
  int n_want;
  const int want_rank = block_scan(creq, s_warp, &n_want);
  const bool ok = creq && want_rank < n_free;
  const int row = s_rbr[mt_clip(want_rank, 0, Q - 1)];
  int n_ok;
  const int ok_rank = block_scan(ok, s_warp, &n_ok);
  const int next = A.next_slot[n];
  const int slot = wadd(next, ok_rank);
  const bool doit = ok && slot < I.C;
  int n_do;
  block_scan(doit, s_warp, &n_do);

  if (t < K) {
    const int op = ltype == T_WRITE ? OP_WRITE
                                    : (ltype == T_CAS ? OP_CAS : OP_READ);
    const int keyk = mt_clip(la, 0, I.keys - 1);
    const bool wc = ltype == T_WRITE || ltype == T_CAS;
    const int v1 = mt_clip(wc ? wadd(lb, 1) : 0, 0, 0xFF);
    const int v2 = mt_clip(ltype == T_CAS ? wadd(lc, 1) : 0, 0, 0xFF);
    if (doit) {
      s_asg[row] = t;
      l_slot[t] = slot;
      l_cmd[t] = (keyk << 18) | (op << 16) | (v1 << 8) | v2;
      l_client[t] = mt_clip(wsub(lsrc, I.n_nodes), 0, 0x7FFF);
      l_mid[t] = lmid;
    }
    // table/slot exhaustion sheds definitely (error 11)
    put_lane(A.out, (long long)n * L + Q + t, creq && !doit && !stalled,
             lsrc, T_ERR, E_UNAVAILABLE, 0, 0, lmid);
  }
  __syncthreads();

  if (t < Q) {
    const int k = s_asg[t];
    if (k >= 0) {
      tv = true;
      ts = l_slot[k];
      tc = l_cmd[k];
      tcl = l_client[k];
      tm = l_mid[k];
      tl = wsub(rnd, I.retry);
    }
    // T_ASSIGN resends: every live row on the retry tick
    const bool due = tv && wsub(rnd, tl) >= I.retry;
    if (due) tl = rnd;
    put_lane(A.out, (long long)n * L + t, due && !stalled,
             I.p_base + mt_mod(ts, I.P), T_ASSIGN, shl16(tcl) | ts, tc, tm,
             -1);
    if (stalled) {
      A.o_t_valid[r] = A.t_valid[r];
      A.o_t_slot[r] = A.t_slot[r];
      A.o_t_cmd[r] = A.t_cmd[r];
      A.o_t_client[r] = A.t_client[r];
      A.o_t_mid[r] = A.t_mid[r];
      A.o_t_last[r] = A.t_last[r];
    } else {
      A.o_t_valid[r] = tv;
      A.o_t_slot[r] = ts;
      A.o_t_cmd[r] = tc;
      A.o_t_client[r] = tcl;
      A.o_t_mid[r] = tm;
      A.o_t_last[r] = tl;
    }
  }
  if (t == 0) A.o_next_slot[n] = stalled ? next : wadd(next, n_do);
}

// --- K24 -------------------------------------------------------------------

struct ProxyArgs {
  Lanes in;
  const u8 *p_valid, *p_learn;  // [n, Q]
  const int *p_slot, *p_cmd, *p_client, *p_mid, *p_last;
  const u8* p_acks;             // [n, Q, AR]
  const int* round;
  const u8* stall;
  Outbox out;                   // [n, Q * AR + Q]
  u8 *o_p_valid, *o_p_learn;
  int *o_p_slot, *o_p_cmd, *o_p_client, *o_p_mid, *o_p_last;
  u8* o_p_acks;
};
constexpr int kProxyPtrs = sizeof(ProxyArgs) / sizeof(void*);

struct ProxyInts {
  int n, K, Q, AR, A, R, rows, cols, leader, a_base, r_base, retry;
};

__global__ void proxy_kernel(ProxyArgs A, ProxyInts I) {
  extern __shared__ int sm[];
  const int K = I.K, Q = I.Q, AR = I.AR;
  int* l_type = sm;              // [K]
  int* l_a = l_type + K;
  int* l_b = l_a + K;
  int* l_c = l_b + K;
  int* l_slot = l_c + K;         // [K] T_ASSIGN's slot and client
  int* l_client = l_slot + K;
  int* s_slot = l_client + K;    // [Q] the rows' slot after retirement
  int* s_rbr = s_slot + Q;       // [Q]
  int* s_asg = s_rbr + Q;        // [Q]
  u8* l_valid = (u8*)(s_asg + Q);  // [K]
  u8* s_live = l_valid + K;      // [Q] p_valid after retirement
  u8* s_acks = s_live + Q;       // [Q * AR]
  __shared__ int s_warp[32];
  const int n = blockIdx.x, t = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const int rnd = A.round[0];
  const int L = Q * AR + Q;
  const long long abase = (long long)n * Q * AR;

  for (int j = t; j < Q * AR; j += blockDim.x) s_acks[j] = A.p_acks[abase + j];
  const long long r = (long long)n * Q + t;
  bool pv = false, pl = false;
  int ps = 0, pc = 0, pcl = 0, pm = 0, plast = 0;
  if (t < Q) {
    pv = A.p_valid[r];
    pl = A.p_learn[r];
    ps = A.p_slot[r];
    pc = A.p_cmd[r];
    pcl = A.p_client[r];
    pm = A.p_mid[r];
    plast = A.p_last[r];
    s_rbr[t] = 0;
    s_asg[t] = -1;
  }
  if (t < K) {
    const long long i = (long long)n * K + t;
    l_valid[t] = A.in.valid[i];
    l_type[t] = A.in.type[i];
    l_a[t] = A.in.a[i];
    l_b[t] = A.in.b[i];
    l_c[t] = A.in.c[i];
  }
  __syncthreads();

  if (t < Q) {
    u8* acks = s_acks + t * AR;
    // acceptor acks onto phase-2 rows, replica acks onto learn rows
    if (pv) {
      const int want = pl ? T_EXEC : T_P2B;
      for (int k = 0; k < K; ++k) {
        const int j = l_b[k];
        if (l_valid[k] && l_type[k] == want && l_a[k] == ps && j >= 0 &&
            j < AR)
          acks[j] = 1;
      }
    }
    // every replica acked: retire the row, T_DONE to the leader
    bool all_r = true;
    for (int j = 0; j < I.R; ++j) all_r = all_r && acks[j];
    const bool done = pv && pl && all_r;
    put_lane(A.out, (long long)n * L + Q * AR + t, done && !stalled,
             I.leader, T_DONE, ps, 0, 0, -1);
    pv = pv && !done;
    // flexible grid quorum: any complete acceptor ROW chooses
    if (pv && !pl) {
      bool chosen = false;
      for (int gr = 0; gr < I.rows && !chosen; ++gr) {
        bool full = true;
        for (int gc = 0; gc < I.cols; ++gc)
          full = full && acks[gr * I.cols + gc];
        chosen = full;
      }
      if (chosen) {
        pl = true;
        for (int j = 0; j < AR; ++j) acks[j] = 0;
        plast = wsub(rnd, I.retry);
      }
    }
    s_live[t] = pv;
    s_slot[t] = ps;
  }
  __syncthreads();

  // new assignments: the first per slot, slots of live rows dropped
  bool asg = false;
  if (t < K && l_valid[t] && l_type[t] == T_ASSIGN) {
    const int slot = l_a[t] & 0x7FFF;
    asg = true;
    for (int k = 0; k < t && asg; ++k)
      if (l_valid[k] && l_type[k] == T_ASSIGN && (l_a[k] & 0x7FFF) == slot)
        asg = false;
    for (int q = 0; q < Q && asg; ++q)
      if (s_live[q] && s_slot[q] == slot) asg = false;
    l_slot[t] = slot;
    l_client[t] = l_a[t] >> 16;
  }
  const int is_free = (t < Q && !pv) ? 1 : 0;
  int n_free;
  const int free_rank = block_scan(is_free, s_warp, &n_free);
  if (is_free) s_rbr[free_rank] = t;
  int n_want;
  const int want_rank = block_scan(asg, s_warp, &n_want);
  if (asg && want_rank < n_free) s_asg[s_rbr[mt_clip(want_rank, 0, Q - 1)]] = t;
  __syncthreads();

  if (t < Q) {
    u8* acks = s_acks + t * AR;
    const int k = s_asg[t];
    if (k >= 0) {
      pv = true;
      pl = false;
      ps = l_slot[k];
      pc = l_b[k];
      pcl = l_client[k];
      pm = l_c[k];
      plast = wsub(rnd, I.retry);
      for (int j = 0; j < AR; ++j) acks[j] = 0;
    }
    // fan-out lanes: row t, lane j -> acceptor j (phase 2a) or replica j
    // (learn), on the retry tick
    const bool due = pv && wsub(rnd, plast) >= I.retry;
    if (due) plast = rnd;
    const long long o = (long long)n * L + (long long)t * AR;
    const int la = pl ? (shl16(pcl) | ps) : ps;
    for (int j = 0; j < AR; ++j)
      put_lane(A.out, o + j, due && (pl ? j < I.R : j < I.A) && !stalled,
               (pl ? I.r_base : I.a_base) + j, pl ? T_LEARN : T_P2A, la, pc,
               pl ? pm : 0, -1);
    if (stalled) {
      A.o_p_valid[r] = A.p_valid[r];
      A.o_p_learn[r] = A.p_learn[r];
      A.o_p_slot[r] = A.p_slot[r];
      A.o_p_cmd[r] = A.p_cmd[r];
      A.o_p_client[r] = A.p_client[r];
      A.o_p_mid[r] = A.p_mid[r];
      A.o_p_last[r] = A.p_last[r];
    } else {
      A.o_p_valid[r] = pv;
      A.o_p_learn[r] = pl;
      A.o_p_slot[r] = ps;
      A.o_p_cmd[r] = pc;
      A.o_p_client[r] = pcl;
      A.o_p_mid[r] = pm;
      A.o_p_last[r] = plast;
    }
  }
  __syncthreads();
  for (int j = t; j < Q * AR; j += blockDim.x)
    A.o_p_acks[abase + j] = stalled ? A.p_acks[abase + j] : s_acks[j];
}

// --- K25, K26: the slot rows ------------------------------------------------

constexpr int kRowThreads = 256;
constexpr int kChunk = kRowThreads * 16;   // slots a copy block

// copies slots [lo, hi) of a row out of place: 16 slots a thread, as
// four int4 of the int32 planes and one uint4 of the byte plane when
// `vec` (C a multiple of 16, every plane 16-byte aligned), else slot by
// slot
template <int NI>
__device__ __forceinline__ void copy_rows(const int* const (&src)[NI],
                                          int* const (&dst)[NI],
                                          const u8* bsrc, u8* bdst,
                                          long long row, int lo, int hi,
                                          bool vec) {
  if (vec) {
    const int s = lo + threadIdx.x * 16;
    if (s < hi) {
#pragma unroll
      for (int p = 0; p < NI; ++p) {
        const int4* in = reinterpret_cast<const int4*>(src[p] + row + s);
        int4* out = reinterpret_cast<int4*>(dst[p] + row + s);
#pragma unroll
        for (int v = 0; v < 4; ++v) out[v] = in[v];
      }
      *reinterpret_cast<uint4*>(bdst + row + s) =
          *reinterpret_cast<const uint4*>(bsrc + row + s);
    }
  } else {
    for (int s = lo + threadIdx.x; s < hi; s += blockDim.x) {
#pragma unroll
      for (int p = 0; p < NI; ++p) dst[p][row + s] = src[p][row + s];
      bdst[row + s] = bsrc[row + s];
    }
  }
}

// the first valid lane of `type` per key among lanes [0, k): whether lane
// k is the first (JAX's _first_per_key on valid & type == want)
__device__ __forceinline__ bool first_of_key(const u8* valid,
                                             const int* type, const int* key,
                                             int k, int want) {
  if (!valid[k] || type[k] != want) return false;
  for (int j = 0; j < k; ++j)
    if (valid[j] && type[j] == want && key[j] == key[k]) return false;
  return true;
}

struct AccArgs {
  Lanes in;
  const int* acc_cmd;  // [n, C]
  const u8* acc_has;   // [n, C]
  const u8* stall;
  Outbox out;          // [n, K]
  int* o_acc_cmd;
  u8* o_acc_has;
};
constexpr int kAccPtrs = sizeof(AccArgs) / sizeof(void*);

__global__ void acc_kernel(AccArgs A, int K, int C, bool vec) {
  extern __shared__ int sm[];
  int* l_type = sm;               // [K]
  int* l_a = l_type + K;
  u8* l_valid = (u8*)(l_a + K);   // [K]
  const int n = blockIdx.x, chunk = blockIdx.y, t = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const long long row = (long long)n * C;
  const int lo = chunk * kChunk, hi = min(C, lo + kChunk);
  {
    const int* src[1] = {A.acc_cmd};
    int* dst[1] = {A.o_acc_cmd};
    copy_rows<1>(src, dst, A.acc_has, A.o_acc_has, row, lo, hi, vec);
  }
  for (int k = t; k < K; k += blockDim.x) {
    const long long i = (long long)n * K + k;
    l_valid[k] = A.in.valid[i];
    l_type[k] = A.in.type[i];
    l_a[k] = A.in.a[i];
  }
  __syncthreads();
  for (int k = t; k < K; k += blockDim.x) {
    const bool keep = first_of_key(l_valid, l_type, l_a, k, T_P2A) &&
                      l_a[k] >= 0 && l_a[k] < C;
    const long long i = (long long)n * K + k;
    if (keep && !stalled && l_a[k] >= lo && l_a[k] < hi) {
      A.o_acc_cmd[row + l_a[k]] = A.in.b[i];
      A.o_acc_has[row + l_a[k]] = 1;
    }
    if (chunk == 0)
      put_lane(A.out, i, keep && !stalled, A.in.src[i], T_P2B, l_a[k], n, 0,
               -1);
  }
}

struct RepArgs {
  Lanes in;
  const int *r_cmd, *r_client, *r_mid;  // [n, C]
  const u8* r_has;                      // [n, C]
  const int* applied;                   // [n]
  const int* kv;                        // [n, keys]
  const u8* stall;
  Outbox out;                           // [n, AP + K]
  int *o_r_cmd, *o_r_client, *o_r_mid;
  u8* o_r_has;
  int *o_applied, *o_kv;
};
constexpr int kRepPtrs = sizeof(RepArgs) / sizeof(void*);

struct RepInts {
  int n, K, C, keys, AP, R, n_nodes, vec;
};

__global__ void rep_kernel(RepArgs A, RepInts I) {
  extern __shared__ int sm[];
  const int K = I.K, C = I.C;
  int* l_type = sm;               // [K]
  int* l_slot = l_type + K;       // [K] the learn's slot (a & 0x7FFF)
  u8* l_valid = (u8*)(l_slot + K);
  u8* l_keep = l_valid + K;       // [K]: deduped T_LEARN in the log
  const int n = blockIdx.x, t = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const long long row = (long long)n * C;
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const bool walker = blockIdx.y == n_chunks;
  const int lo = blockIdx.y * kChunk, hi = min(C, lo + kChunk);
  if (!walker) {
    const int* src[3] = {A.r_cmd, A.r_client, A.r_mid};
    int* dst[3] = {A.o_r_cmd, A.o_r_client, A.o_r_mid};
    copy_rows<3>(src, dst, A.r_has, A.o_r_has, row, lo, hi, I.vec);
  }
  for (int k = t; k < K; k += blockDim.x) {
    const long long i = (long long)n * K + k;
    l_valid[k] = A.in.valid[i];
    l_type[k] = A.in.type[i];
    l_slot[k] = A.in.a[i] & 0x7FFF;
  }
  __syncthreads();
  for (int k = t; k < K; k += blockDim.x) {
    const bool keep =
        first_of_key(l_valid, l_type, l_slot, k, T_LEARN) && l_slot[k] < C;
    l_keep[k] = keep;
    const long long i = (long long)n * K + k;
    if (!walker && keep && !stalled && l_slot[k] >= lo && l_slot[k] < hi) {
      const long long s = row + l_slot[k];
      A.o_r_cmd[s] = A.in.b[i];
      A.o_r_client[s] = A.in.a[i] >> 16;
      A.o_r_mid[s] = A.in.c[i];
      A.o_r_has[s] = 1;
    }
    if (walker)  // storage acks: every deduped learn acks once stored
      put_lane(A.out, (long long)n * (I.AP + K) + I.AP + k,
               keep && !stalled, A.in.src[i], T_EXEC, l_slot[k], n, 0, -1);
  }
  if (!walker) return;

  // the in-order apply over the key row in shared memory
  int* s_kv = l_type + 2 * K + (2 * K + 3) / 4;
  const long long krow = (long long)n * I.keys;
  for (int j = t; j < I.keys; j += blockDim.x) s_kv[j] = A.kv[krow + j];
  __syncthreads();
  if (t == 0) {
    int applied = A.applied[n];
    for (int step = 0; step < I.AP; ++step) {
      const int idx = wadd(applied, 1);
      const int safe = mt_clip(idx, 0, C - 1);
      // the slot as this round's learns left it
      int lane = -1;
      for (int k = 0; k < K; ++k)
        if (l_keep[k] && l_slot[k] == safe) lane = k;
      const long long li = (long long)n * K + (lane < 0 ? 0 : lane);
      const bool has = lane >= 0 || A.r_has[row + safe];
      const int cmd = lane >= 0 ? A.in.b[li] : A.r_cmd[row + safe];
      const int client =
          lane >= 0 ? (A.in.a[li] >> 16) : A.r_client[row + safe];
      const int mid = lane >= 0 ? A.in.c[li] : A.r_mid[row + safe];
      const bool active = idx < C && has;
      const int key = (cmd >> 18) & 0xFFF, op = (cmd >> 16) & 0x3;
      const int v1 = (cmd >> 8) & 0xFF, v2 = cmd & 0xFF;
      const bool in_row = key < I.keys;
      const int cur = in_row ? s_kv[key] : (int)0x80000000u;
      const bool cas_ok = op == OP_CAS && cur == v1 && cur > 0;
      if (active && in_row && (op == OP_WRITE || cas_ok))
        s_kv[key] = op == OP_WRITE ? v1 : v2;
      if (active) applied = idx;
      const bool desig = active && mt_mod(idx, I.R) == n && mid >= 0 &&
                         op != OP_NOOP;
      int rtype, ra;
      if (op == OP_READ) {
        rtype = cur > 0 ? T_READ_OK : T_ERR;
        ra = cur > 0 ? cur : 20;
      } else {
        rtype = op == OP_WRITE ? T_WRITE_OK : (cas_ok ? T_CAS_OK : T_ERR);
        ra = (op == OP_CAS && !cas_ok) ? (cur > 0 ? 22 : 20) : 0;
      }
      put_lane(A.out, (long long)n * (I.AP + K) + step, desig && !stalled,
               wadd(I.n_nodes, client), rtype, ra, 0, 0, mid);
    }
    A.o_applied[n] = stalled ? A.applied[n] : applied;
  }
  __syncthreads();
  for (int j = t; j < I.keys; j += blockDim.x)
    A.o_kv[krow + j] = stalled ? A.kv[krow + j] : s_kv[j];
}

}  // namespace

// ptrs: the inbox's valid, src, mid, type, a, b, c; next_slot, t_valid,
//       t_slot, t_cmd, t_client, t_mid, t_last; round; stall (or null);
//       the outbox's ten fields ([n, Q + K]); the seven state outputs
// ints: n, K, Q (leader_slots), C (log_cap), keys, n_nodes (the cluster),
//       p_base, P, retry
MT_API int mt_compartment_sequencer_step(void* const* p, int n_ptrs,
                                         const long long* v, int n_ints,
                                         void* stream) {
  constexpr int kInts = sizeof(SeqInts) / sizeof(int);
  if (mt_bad_args(n_ptrs, kSeqPtrs, n_ints, kInts))
    return cudaErrorInvalidValue;
  SeqArgs A;
  memcpy(&A, p, sizeof(A));
  SeqInts I;
  int* f = (int*)&I;
  for (int j = 0; j < kInts; ++j) f[j] = (int)v[j];
  const int threads = block_threads(I.Q > I.K ? I.Q : I.K);
  if (I.n < 1 || I.K < 1 || I.Q < 1 || I.P < 1 || I.keys < 1 ||
      threads > 1024)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(5 * I.K + 2 * I.Q) * sizeof(int) + I.K;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  seq_kernel<<<I.n, threads, smem, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}

// ptrs: the inbox's valid, src, mid, type, a, b, c; p_valid, p_learn,
//       p_slot, p_cmd, p_client, p_mid, p_last, p_acks; round; stall (or
//       null); the outbox's ten fields ([n, Q * AR + Q]); the eight state
//       outputs
// ints: n, K, Q (proxy_slots), AR, A, R, rows, cols, leader, a_base,
//       r_base, retry
MT_API int mt_compartment_proxy_step(void* const* p, int n_ptrs,
                                     const long long* v, int n_ints,
                                     void* stream) {
  constexpr int kInts = sizeof(ProxyInts) / sizeof(int);
  if (mt_bad_args(n_ptrs, kProxyPtrs, n_ints, kInts))
    return cudaErrorInvalidValue;
  ProxyArgs A;
  memcpy(&A, p, sizeof(A));
  ProxyInts I;
  int* f = (int*)&I;
  for (int j = 0; j < kInts; ++j) f[j] = (int)v[j];
  const int threads = block_threads(I.Q > I.K ? I.Q : I.K);
  if (I.n < 1 || I.K < 1 || I.Q < 1 || I.AR < I.A || I.AR < I.R ||
      I.rows * I.cols != I.A || threads > 1024)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(6 * I.K + 3 * I.Q) * sizeof(int) + I.K +
                      I.Q + (size_t)I.Q * I.AR;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  proxy_kernel<<<I.n, threads, smem, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}

// ptrs: the inbox's valid, src, mid, type, a, b, c; acc_cmd, acc_has;
//       stall (or null); the outbox's ten fields ([n, K]); o_acc_cmd,
//       o_acc_has
// ints: n, K, C (log_cap), vec (C % 16 == 0 and the rows 16-byte aligned)
MT_API int mt_compartment_acceptor_step(void* const* p, int n_ptrs,
                                        const long long* v, int n_ints,
                                        void* stream) {
  if (mt_bad_args(n_ptrs, kAccPtrs, n_ints, 4)) return cudaErrorInvalidValue;
  AccArgs A;
  memcpy(&A, p, sizeof(A));
  const int n = (int)v[0], K = (int)v[1], C = (int)v[2];
  if (n < 1 || K < 1 || C < 1) return cudaErrorInvalidValue;
  const dim3 grid(n, (C + kChunk - 1) / kChunk);
  const size_t smem = (size_t)2 * K * sizeof(int) + K;
  acc_kernel<<<grid, kRowThreads, smem, (cudaStream_t)stream>>>(A, K, C,
                                                                 v[3] != 0);
  return cudaGetLastError();
}

// ptrs: the inbox's valid, src, mid, type, a, b, c; r_cmd, r_client,
//       r_mid, r_has, applied, kv; stall (or null); the outbox's ten
//       fields ([n, AP + K]); the six state outputs
// ints: n, K, C (log_cap), keys, AP, R, n_nodes (the cluster), vec
MT_API int mt_compartment_replica_step(void* const* p, int n_ptrs,
                                       const long long* v, int n_ints,
                                       void* stream) {
  constexpr int kInts = sizeof(RepInts) / sizeof(int);
  if (mt_bad_args(n_ptrs, kRepPtrs, n_ints, kInts))
    return cudaErrorInvalidValue;
  RepArgs A;
  memcpy(&A, p, sizeof(A));
  RepInts I;
  int* f = (int*)&I;
  for (int j = 0; j < kInts; ++j) f[j] = (int)v[j];
  if (I.n < 1 || I.K < 1 || I.C < 1 || I.keys < 1 || I.R < 1 || I.AP < 0)
    return cudaErrorInvalidValue;
  const dim3 grid(I.n, (I.C + kChunk - 1) / kChunk + 1);
  const size_t smem = (size_t)(2 * I.K + (2 * I.K + 3) / 4 + I.keys) *
                      sizeof(int);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  rep_kernel<<<grid, kRowThreads, smem, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}
