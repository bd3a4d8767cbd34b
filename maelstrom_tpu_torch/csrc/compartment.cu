// K23 compartment_sequencer_step, K24 compartment_proxy_step, K25
// compartment_acceptor_step and K26 compartment_replica_step: the role
// steps of compartmentalized consensus with one sequencer
// (maelstrom_tpu/nodes/compartment.py); K27 compartment_sequencer_elect,
// K28 compartment_proxy_elect and K29 compartment_acceptor_elect: those
// of an elected tier (S > 1), where K26 serves too. Each has the pool
// round's freeze of killed and paused nodes fused.
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
// without the ballot branches). One block a proxy, one
// thread a table row and an inbox lane, the [Q, AR] ack flags in shared
// memory. In JAX's order: P2B and EXEC acks fold onto the rows (ack j is
// lane b == j), rows whose R replicas all acked retire (T_DONE lanes
// [Q * AR, Q * AR + Q)), a row whose acks cover a whole grid row is
// chosen (learn, acks cleared, due now), then T_ASSIGN lanes are deduped
// by slot (the first per slot; slots held by a live row drop) and fill
// free rows by rank. Last the fan lanes [q * AR + j]: T_P2A to acceptor j
// < A or T_LEARN to replica j < R, for the rows due on the retry tick.
// With the adversary (the flag `byz`, compartment.py:948-1000) a deduped
// assign that hits a live row of its slot with another command is
// convicted before the hit: dropped, counted into the proxy's evidence
// planes and NACKed T_ERR / E_BYZANTINE to its source on lanes
// [Q * AR + Q, Q * AR + Q + K) (see "the proxies' conviction lanes").
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
// reads JAX's gather fill (INT32_MIN) and writes nothing. The learn
// word's layout is an argument: client<<16 | slot with one sequencer,
// client<<12 | slot (12-bit fields) with an elected tier.
//
// K27 replaces SequencerRole._step_elect (compartment.py:524-801), in
// JAX's phase order. One block a candidate, a thread a table row and an
// inbox lane, the candidate's done_bits row in shared memory. Thread 0
// observes the ballots (HB / NLDR a, REJP c), deposes or aborts and
// re-arms the detector with the round's jitter (drawn beside it by K7);
// the rows retire on T_DONE and the deduped T_DONE lanes set their
// done_bits; thread 0 advances the frontier exactly 8 steps, folds the
// T_PROM lanes in lane order, decides the win by a whole grid column,
// and decides a candidacy start (its ballot, overflow and parked
// deadline); meanwhile each query row folds the T_QVAL lanes in lane
// order (the lowest lane of the strictly highest ballot wins) and
// resolves on a column of answers. Block scans allocate recovery rows
// first, then the served requests' rows on what is left; redirects and
// sheds go to the error lanes. The fan (T_QRY to the acceptors that
// have not answered, T_ASSIGN on lane 0) is written lane by lane from the
// rows' words in shared memory, then the prepare, watermark and
// heartbeat lanes.
//
// K28 replaces ProxyRole.step with ballots (compartment.py:877-1060, the
// S > 1 branches). K24's order: acks fold (a
// P2B must echo the row's ballot), retire (T_DONE to ballot % S), the
// row quorum; then T_P2R drops the fenced rows and each hit lane sends
// T_NLDR to the stale leader (the highest fenced ballot, 0 where no row
// was hit); an upgrade (a higher-ballot assign of a live slot) frees its
// row, a stale assign drops, and the assigns fill free rows by rank. The
// fan (P2A c = the row's ballot) is written lane by lane. With the
// adversary the conviction runs after the fence drop and before the
// upgrade: an equivocation (a live row of the slot at the same ballot
// with another command) or a stale ballot (ballot % S != src) leaves the
// assigns that the upgrade loop and the rank scans read, and is NACKed on
// lanes [Q * AR + Q + K, Q * AR + Q + 2K).
//
// K29 replaces AcceptorRole._step_elect (compartment.py:1115-1200). The
// grid of K25 copies acc_cmd, acc_bal and acc_has out of place; every
// block derives the round's promise floor (the highest deduped prepare)
// and the accepted lanes, and writes those in its chunk. The chunk-0
// block writes one reply a lane with JAX's cascade of type, b and c; a
// T_QRY (and every lane's fallthrough fields) reads its slot as this
// round's accepts leave it, through the accepted lanes over the input
// planes, so no block order is needed.
//
// Every kernel writes every field of its outbox as the plain versions
// build it (Msgs.empty: src, due, mid, b, c 0 and reply_to -1, except
// where a lane sets them). With the optional stall plane [n] a stalled
// node keeps its state rows and every lane of it is written invalid; the
// other fields are those of the unstalled step, as the JAX round's freeze
// leaves them. No kernel updates an input. int32 adds, subtractions and
// shifts wrap (unsigned arithmetic), as XLA's do.
//
// Bound: bytes. K23, K24, K27 and K28 read and write their [n, Q] tables
// and the inbox and write the outbox, a few dozen integer operations a
// row and a lane (K24's and K28's ack fold Q x K x AR); K25, K26 and K29
// read and write their [n, C] rows (K25 5 bytes a slot, K26 13, K29 9),
// which dominate at a full-size log.
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

// --- the proxies' conviction lanes (K24 and K28 with the adversary) --------
//
// Behind the integer flag `byz` and the eight optional evidence planes [n]
// (z_eq, z_sb, z_eq_src, z_eq_slot, z_eq_rnd, z_sb_src, z_sb_bal,
// z_sb_rnd: nodes/compartment.py Z_KEYS) in and out; with the flag off the
// planes are null and nothing of this runs. The dynamic shared memory then
// grows by a region 4-byte aligned past the proxy's own: the six block
// counters (equivocations, stale ballots and the four witness maxima),
// the lanes' src and the rows' commands.

constexpr int T_ERR_LANE = 1, E_BYZANTINE = 32;

struct Evidence {
  const int* z[8];   // [n] each, or null without the adversary
  int* o_z[8];
};

__device__ __forceinline__ int* conv_region(u8* end) {
  return (int*)(((unsigned long long)end + 3) & ~3ull);
}

size_t conv_smem(int K, int Q) { return (size_t)(6 + K + Q) * 4 + 4; }

__device__ __forceinline__ void conv_note(int* c, bool eq, bool sb, int src,
                                          int slot, int bal) {
  if (eq) {
    atomicAdd(&c[0], 1);
    atomicMax(&c[2], src);
    atomicMax(&c[3], slot);
  }
  if (sb) {
    atomicAdd(&c[1], 1);
    atomicMax(&c[4], src);
    atomicMax(&c[5], bal);
  }
}

// thread 0, after the block's counters are final: the counts grow, a
// first conviction stamps its round while the count was 0, the witnesses
// take the maxima of this round's convicted lanes (each its own maximum);
// a stalled proxy keeps its evidence
__device__ __forceinline__ void conv_write(const Evidence& E, const int* c,
                                           int n, int rnd, bool stalled) {
  int z[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) z[j] = E.z[j][n];
  if (!stalled) {
    const bool eq = c[0] > 0, sb = c[1] > 0;
    if (eq && z[0] == 0) z[4] = rnd;
    if (sb && z[1] == 0) z[7] = rnd;
    z[0] = wadd(z[0], c[0]);
    z[1] = wadd(z[1], c[1]);
    if (eq) {
      z[2] = c[2];
      z[3] = c[3];
    }
    if (sb) {
      z[5] = c[4];
      z[6] = c[5];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) E.o_z[j][n] = z[j];
}

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
  Evidence ev;                  // the conviction lanes' planes, or null
};
constexpr int kProxyPtrs = sizeof(ProxyArgs) / sizeof(void*);

struct ProxyInts {
  int n, K, Q, AR, A, R, rows, cols, leader, a_base, r_base, retry, byz;
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
  // with the adversary: the block's counters, the lanes' src, the rows'
  // commands
  int* c_conv = conv_region(s_acks + Q * AR);
  int* l_src = c_conv + 6;
  int* s_cmd = l_src + K;
  __shared__ int s_warp[32];
  const int n = blockIdx.x, t = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const bool byz = I.byz != 0;
  const int rnd = A.round[0];
  const int L = Q * AR + Q + (byz ? K : 0);
  const long long abase = (long long)n * Q * AR;
  if (byz && t < 6) c_conv[t] = t < 2 ? 0 : -1;

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
    if (byz) l_src[t] = A.in.src[i];
  }
  if (byz && t < Q) s_cmd[t] = pc;
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

  // new assignments: the first per slot, slots of live rows dropped.
  // With the adversary a first-per-slot assign that hits a live row of its
  // slot with another command is an equivocation: convicted, dropped and
  // NACKed to its source (lanes [Q * AR + Q, L))
  bool asg = false, eq = false;
  if (t < K && l_valid[t] && l_type[t] == T_ASSIGN) {
    const int slot = l_a[t] & 0x7FFF;
    asg = true;
    for (int k = 0; k < t && asg; ++k)
      if (l_valid[k] && l_type[k] == T_ASSIGN && (l_a[k] & 0x7FFF) == slot)
        asg = false;
    if (byz && asg) {
      for (int q = 0; q < Q && !eq; ++q)
        eq = s_live[q] && s_slot[q] == slot && s_cmd[q] != l_b[t];
      asg = !eq;
      if (eq) conv_note(c_conv, true, false, l_src[t], slot, 0);
    }
    for (int q = 0; q < Q && asg; ++q)
      if (s_live[q] && s_slot[q] == slot) asg = false;
    l_slot[t] = slot;
    l_client[t] = l_a[t] >> 16;
  }
  if (byz && t < K)
    put_lane(A.out, (long long)n * L + Q * AR + Q + t, eq && !stalled,
             l_src[t], T_ERR_LANE, E_BYZANTINE, l_a[t] & 0x7FFF, 0, -1);
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
  if (byz && t == 0) conv_write(A.ev, c_conv, n, rnd, stalled);
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
  // the learn word: slot = a & slot_mask, client = (a >> cshift) & cmask
  // (0x7FFF, 16, -1 with one sequencer; 0xFFF, 12, 0xFFF elected)
  int n, K, C, keys, AP, R, n_nodes, vec, slot_mask, cshift, cmask;
};

__global__ void rep_kernel(RepArgs A, RepInts I) {
  extern __shared__ int sm[];
  const int K = I.K, C = I.C;
  int* l_type = sm;               // [K]
  int* l_slot = l_type + K;       // [K] the learn's slot (a & slot_mask)
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
    l_slot[k] = A.in.a[i] & I.slot_mask;
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
      A.o_r_client[s] = (A.in.a[i] >> I.cshift) & I.cmask;
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
      const int client = lane >= 0 ? ((A.in.a[li] >> I.cshift) & I.cmask)
                                   : A.r_client[row + safe];
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

// --- K27, K28, K29: the elected tier ----------------------------------------

constexpr int T_PREP = 36, T_PROM = 37, T_REJP = 38, T_P2R = 39, T_QRY = 40,
              T_QVAL = 41, T_HB = 42, T_NLDR = 43, T_CMT = 44,
              E_NOT_LEADER = 31;

__device__ __forceinline__ int wmul(int x, int y) {
  return (int)((unsigned)x * (unsigned)y);
}
__device__ __forceinline__ int shl(int x, int k) {
  return (int)((unsigned)x << k);
}
// floor division, as jnp's // on int32 (d > 0)
__device__ __forceinline__ int floordiv(int x, int d) {
  const int q = x / d;
  return (q * d != x && x < 0) ? q - 1 : q;
}
// 1 << clip(x, 0, 30)
__device__ __forceinline__ int bit30(int x) { return 1 << mt_clip(x, 0, 30); }

// whether the grid bitmask `bits` (index r * cols + c) holds a whole
// column: the phase-1 quorum
__device__ __forceinline__ bool col_quorum(int bits, int rows, int cols) {
  for (int c = 0; c < cols; ++c) {
    bool all = true;
    for (int r = 0; r < rows && all; ++r)
      all = ((bits >> (r * cols + c)) & 1) != 0;
    if (all) return true;
  }
  return false;
}

// the packed command of a client request lane (read, write or cas)
__device__ __forceinline__ int client_cmd(int type, int a, int b, int c,
                                          int keys) {
  const int op = type == T_WRITE ? OP_WRITE : (type == T_CAS ? OP_CAS
                                                             : OP_READ);
  const int keyk = mt_clip(a, 0, keys - 1);
  const bool wc = type == T_WRITE || type == T_CAS;
  const int v1 = mt_clip(wc ? wadd(b, 1) : 0, 0, 0xFF);
  const int v2 = mt_clip(type == T_CAS ? wadd(c, 1) : 0, 0, 0xFF);
  return (keyk << 18) | (op << 16) | (v1 << 8) | v2;
}

struct SeqElectArgs {
  Lanes in;
  // the state, in SEQ_ELECT_ALL's order
  const int* next_slot;                                          // [n]
  const u8* t_valid;                                             // [n, Q]
  const int *t_slot, *t_cmd, *t_client, *t_mid, *t_last;         // [n, Q]
  const int *bal, *seen;                                         // [n]
  const u8 *leading, *electing;                                  // [n]
  const int *prom, *cand_round, *rec_hi, *rec_next, *heard, *deadline,
      *boff, *hb_last, *elect_last;                              // [n]
  const int* t_bal;                                              // [n, Q]
  const u8* t_q;                                                 // [n, Q]
  const int *t_qmask, *t_qbal;                                   // [n, Q]
  const u8* done_bits;                                           // [n, C]
  const int *dfront, *won_count, *won_sum, *won_max, *bal_overflow;  // [n]
  const int* jit;     // [n] the round's election jitter
  const int* round;   // [1]
  const u8* stall;    // [n] or null
  Outbox out;         // [n, Q * AR + 2A + S + K]
  int* o_next_slot;
  u8* o_t_valid;
  int *o_t_slot, *o_t_cmd, *o_t_client, *o_t_mid, *o_t_last;
  int *o_bal, *o_seen;
  u8 *o_leading, *o_electing;
  int *o_prom, *o_cand_round, *o_rec_hi, *o_rec_next, *o_heard, *o_deadline,
      *o_boff, *o_hb_last, *o_elect_last;
  int* o_t_bal;
  u8* o_t_q;
  int *o_t_qmask, *o_t_qbal;
  u8* o_done_bits;
  int *o_dfront, *o_won_count, *o_won_sum, *o_won_max, *o_bal_overflow;
};
constexpr int kSeqElectPtrs = sizeof(SeqElectArgs) / sizeof(void*);

struct SeqElectInts {
  int n, K, Q, C, keys, n_nodes, p_base, P, retry, S, A, AR, a_base, s_base,
      rows, cols, etimeout, bal_width;
};

// a candidate's scalars, as the phases leave them
struct Cand {
  int bal0, bal, seen, prom, cand_round, rec_hi, rec_next, heard, deadline,
      boff, hb_last, elect_last, dfront, won_count, won_sum, won_max,
      bal_overflow, next_slot;
  bool leading, electing, dep, start, ptick, htick;
};

__global__ void seq_elect_kernel(SeqElectArgs A, SeqElectInts I) {
  extern __shared__ int sm[];
  const int K = I.K, Q = I.Q, C = I.C;
  int* l_type = sm;               // [K] the lanes
  int* l_a = l_type + K;
  int* l_b = l_a + K;
  int* l_c = l_b + K;
  int* l_src = l_c + K;
  int* l_mid = l_src + K;
  int* l_slot = l_mid + K;        // [K] a served request's slot
  int* s_rbr = l_slot + K;        // [Q] row by free rank
  int* s_rec = s_rbr + Q;         // [Q] the recovery lane filling the row
  int* s_srv = s_rec + Q;         // [Q] the client lane filling the row
  int* f_dest = s_srv + Q;        // [Q] a row's T_ASSIGN proxy
  int* f_qm = f_dest + Q;         // [Q] a row's answered-acceptor mask
  u8* l_valid = (u8*)(f_qm + Q);  // [K]
  u8* s_done = l_valid + K;       // [C] the done_bits row
  u8* f_flag = s_done + C;        // [Q] 1: due and live, 2: a query row
  // the rows' fan words (a, b, c) reuse s_rbr, s_rec and s_srv once the
  // allocations have read them
  int* f_a = s_rbr;
  int* f_b = s_rec;
  int* f_c = s_srv;
  __shared__ int s_warp[32];
  __shared__ Cand cd;
  const int n = blockIdx.x, t = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const int rnd = A.round[0];
  const int L = Q * I.AR + 2 * I.A + I.S + K;
  const long long ob = (long long)n * L;
  const long long crow = (long long)n * C;

  for (int j = t; j < C; j += blockDim.x) s_done[j] = A.done_bits[crow + j];
  const long long r = (long long)n * Q + t;
  bool tv = false, tq = false;
  int ts = 0, tc = 0, tcl = 0, tm = 0, tl = 0, tb = 0, tqm = 0, tqb = 0;
  if (t < Q) {
    tv = A.t_valid[r];
    ts = A.t_slot[r];
    tc = A.t_cmd[r];
    tcl = A.t_client[r];
    tm = A.t_mid[r];
    tl = A.t_last[r];
    tb = A.t_bal[r];
    tq = A.t_q[r];
    tqm = A.t_qmask[r];
    tqb = A.t_qbal[r];
    s_rbr[t] = 0;
    s_rec[t] = -1;
    s_srv[t] = -1;
  }
  bool lv = false;
  int ltype = 0, la = 0, lb = 0, lc = 0, lsrc = 0, lmid = 0;
  if (t < K) {
    const long long i = (long long)n * K + t;
    lv = A.in.valid[i];
    ltype = A.in.type[i];
    la = A.in.a[i];
    lb = A.in.b[i];
    lc = A.in.c[i];
    lsrc = A.in.src[i];
    lmid = A.in.mid[i];
    l_valid[t] = lv;
    l_type[t] = ltype;
    l_a[t] = la;
    l_b[t] = lb;
    l_c[t] = lc;
    l_src[t] = lsrc;
    l_mid[t] = lmid;
  }
  __syncthreads();
  if (t == 0) {
    // observe ballots: heartbeats, depose notices, rejections
    const int bal = A.bal[n];
    int obs = -1;
    for (int k = 0; k < K; ++k) {
      if (!l_valid[k]) continue;
      if (l_type[k] == T_HB || l_type[k] == T_NLDR) obs = max(obs, l_a[k]);
      else if (l_type[k] == T_REJP) obs = max(obs, l_c[k]);
    }
    const int seen = max(A.seen[n], obs);
    bool hb_cur = false, rj = false;
    for (int k = 0; k < K; ++k) {
      if (!l_valid[k]) continue;
      hb_cur = hb_cur || (l_type[k] == T_HB && l_a[k] >= seen);
      rj = rj || (l_type[k] == T_REJP && l_a[k] == bal);
    }
    const bool higher = seen > bal;
    const bool lead0 = A.leading[n], elect0 = A.electing[n];
    const bool dep = lead0 && higher;
    const bool abort_ = elect0 && (higher || rj);
    const int jit = A.jit[n];
    cd.bal0 = bal;
    cd.seen = seen;
    cd.heard = hb_cur ? rnd : A.heard[n];
    cd.dep = dep;
    cd.leading = lead0 && !dep;
    cd.electing = elect0 && !abort_;
    cd.boff = (abort_ || dep) ? wadd(wadd(rnd, I.retry), jit) : A.boff[n];
    cd.deadline = (hb_cur || abort_ || dep)
                      ? wadd(wadd(wadd(rnd, I.etimeout), n * 2 * I.retry), jit)
                      : A.deadline[n];
  }
  __syncthreads();

  // T_DONE retires rows (slot-keyed) and feeds the commit watermark
  if (t < Q) {
    tv = tv && !cd.dep;
    for (int k = 0; k < K && tv; ++k)
      if (l_valid[k] && l_type[k] == T_DONE && l_a[k] == ts) tv = false;
  }
  if (t < K && first_of_key(l_valid, l_type, l_a, t, T_DONE) && la >= 0 &&
      la < C)
    s_done[la] = 1;
  __syncthreads();

  if (t == 0) {
    // the bounded 8-step frontier advance, then the T_PROM fold
    int dfront = A.dfront[n];
    for (int step = 0; step < 8; ++step) {
      const int nxt = mt_clip(wadd(dfront, 1), 0, C - 1);
      if (s_done[nxt] && wadd(dfront, 1) < C) dfront = wadd(dfront, 1);
    }
    int prom = A.prom[n], rec_hi = A.rec_hi[n];
    for (int k = 0; k < K; ++k) {
      if (!(l_valid[k] && l_type[k] == T_PROM && cd.electing &&
            l_a[k] == cd.bal0))
        continue;
      prom |= bit30(l_b[k]);
      rec_hi = max(rec_hi, wsub(l_c[k] & 0x1FFF, 1));
      dfront = max(dfront, wsub(l_c[k] >> 13, 1));
    }
    const bool won = cd.electing && col_quorum(prom, I.rows, I.cols);
    bool leading = cd.leading || won, electing = cd.electing && !won;
    const int dur = won ? wsub(rnd, A.cand_round[n]) : 0;
    cd.next_slot = won ? wadd(rec_hi, 1) : A.next_slot[n];
    cd.rec_next = won ? wadd(dfront, 1) : A.rec_next[n];
    cd.heard = won ? rnd : cd.heard;
    cd.won_count = wadd(A.won_count[n], won ? 1 : 0);
    cd.won_sum = wadd(A.won_sum[n], dur);
    cd.won_max = max(A.won_max[n], dur);
    int hb_last = won ? wsub(rnd, I.retry) : A.hb_last[n];
    // candidacy start: the detector fired, the backoff spent (no table
    // row is allocated this round when it starts: it does not lead)
    bool start = !leading && !electing && rnd > cd.deadline && rnd >= cd.boff;
    const int newbal =
        wadd(wmul(wadd(floordiv(max(cd.bal0, cd.seen), I.S), 1), I.S), n);
    const bool over = start && newbal >= (1 << I.bal_width);
    start = start && !over;
    cd.bal = start ? newbal : cd.bal0;
    cd.bal_overflow = wadd(A.bal_overflow[n], over ? 1 : 0);
    cd.deadline = over ? 0x7FFFFFFF : cd.deadline;
    electing = electing || start;
    cd.prom = start ? 0 : prom;
    cd.rec_hi = start ? -1 : rec_hi;
    cd.cand_round = start ? rnd : A.cand_round[n];
    int elect_last = start ? wsub(rnd, I.retry) : A.elect_last[n];
    cd.start = start;
    // the outbox ticks
    cd.ptick = electing && wsub(rnd, elect_last) >= I.retry;
    cd.elect_last = cd.ptick ? rnd : elect_last;
    cd.htick = leading && wsub(rnd, hb_last) >= I.retry;
    cd.hb_last = cd.htick ? rnd : hb_last;
    cd.dfront = dfront;
    cd.leading = leading;
    cd.electing = electing;
  }
  // T_QVAL folds onto query-phase rows, lane by lane (the lowest lane of
  // the strictly highest ballot wins)
  if (t < Q) {
    const bool q0 = tq;
    if (tv && q0) {
      for (int k = 0; k < K; ++k) {
        if (!(l_valid[k] && l_type[k] == T_QVAL && l_a[k] == ts)) continue;
        tqm |= bit30((l_c[k] >> 16) & 0x7FFF);
        const int qb = wsub(l_c[k] & 0xFFFF, 1);
        if (qb > tqb) {
          tqb = qb;
          tc = l_b[k];
        }
      }
    }
    // a column of answers resolves the slot; a NO-OP fills a gap
    if (tv && q0 && col_quorum(tqm, I.rows, I.cols)) {
      tq = false;
      if (tqb < 0) tc = 0;
      tl = wsub(rnd, I.retry);
    }
  }
  __syncthreads();

  // recovery rows first, on the table the retirement left
  const int is_free = (t < Q && !tv) ? 1 : 0;
  int n_free;
  const int free_rank = block_scan(is_free, s_warp, &n_free);
  if (is_free) s_rbr[free_rank] = t;
  const bool want_rec =
      t < K && cd.leading && wadd(cd.rec_next, t) <= cd.rec_hi;
  int n_want;
  const int want_rank = block_scan(want_rec, s_warp, &n_want);
  const bool okr = want_rec && want_rank < n_free;
  if (okr) s_rec[s_rbr[mt_clip(want_rank, 0, Q - 1)]] = t;
  int n_okr;
  block_scan(okr, s_warp, &n_okr);
  if (t < Q && s_rec[t] >= 0) {
    tv = true;
    ts = wadd(cd.rec_next, s_rec[t]);
    tc = 0;
    tcl = 0;
    tm = -1;  // recovered: no reply
    tb = cd.bal0;
    tq = true;
    tqm = 0;
    tqb = -1;
    tl = wsub(rnd, I.retry);
  }
  const int rec_next = wadd(cd.rec_next, n_okr);

  // then the clients', on what is left
  const int is_free2 = (t < Q && !tv) ? 1 : 0;
  int n_free2;
  const int free_rank2 = block_scan(is_free2, s_warp, &n_free2);
  if (is_free2) s_rbr[free_rank2] = t;
  const bool creq =
      t < K && lv && (ltype == T_READ || ltype == T_WRITE || ltype == T_CAS);
  const bool serve = creq && cd.leading;
  int n_serve;
  const int serve_rank = block_scan(serve, s_warp, &n_serve);
  const bool ok = serve && serve_rank < n_free2;
  const int row = s_rbr[mt_clip(serve_rank, 0, Q - 1)];
  int n_ok;
  const int ok_rank = block_scan(ok, s_warp, &n_ok);
  const int slot = wadd(cd.next_slot, ok_rank);
  const bool doit = ok && slot < C;
  if (doit) {
    s_srv[row] = t;
    l_slot[t] = slot;
  }
  int n_do;
  block_scan(doit, s_warp, &n_do);
  if (t < Q && s_srv[t] >= 0) {
    const int k = s_srv[t];
    tv = true;
    ts = l_slot[k];
    tc = client_cmd(l_type[k], l_a[k], l_b[k], l_c[k], I.keys);
    tcl = mt_clip(wsub(l_src[k], I.n_nodes), 0, 0xFFF);
    tm = l_mid[k];
    tb = cd.bal0;
    tq = false;
    tl = wsub(rnd, I.retry);
  }
  // shed (backpressure, code 11) and redirect (code 31 + hint)
  if (t < K) {
    const bool redir = creq && !cd.leading;
    const bool shed = serve && !doit;
    const int lead_of = mt_mod(cd.seen, I.S);
    const bool know = wsub(rnd, cd.heard) <= I.etimeout && lead_of != n;
    put_lane(A.out, ob + Q * I.AR + 2 * I.A + I.S + t,
             (shed || redir) && !stalled, lsrc, T_ERR,
             redir ? E_NOT_LEADER : E_UNAVAILABLE,
             redir ? (know ? lead_of : -1) : 0, 0, lmid);
  }

  // the lanes: per-row fan (T_QRY to the acceptors that have not
  // answered, T_ASSIGN on lane 0), prepares, the commit watermark,
  // heartbeats. A row's fan words go to shared memory, and the block
  // writes the [Q, AR] fan lanes in lane order (coalesced)
  __syncthreads();
  if (t < Q) {
    tv = tv && !cd.start;
    const bool due = tv && wsub(rnd, tl) >= I.retry;
    if (due) tl = rnd;
    f_flag[t] = (due && !stalled ? 1 : 0) | (tq ? 2 : 0);
    f_dest[t] = I.p_base + mt_mod(ts, I.P);
    f_qm[t] = tqm;
    f_a[t] = tq ? ts : (shl(tb, 24) | shl(tcl, 12) | ts);
    f_b[t] = tq ? 0 : tc;
    f_c[t] = tq ? tb : tm;
    if (stalled) {
      A.o_t_valid[r] = A.t_valid[r];
      A.o_t_slot[r] = A.t_slot[r];
      A.o_t_cmd[r] = A.t_cmd[r];
      A.o_t_client[r] = A.t_client[r];
      A.o_t_mid[r] = A.t_mid[r];
      A.o_t_last[r] = A.t_last[r];
      A.o_t_bal[r] = A.t_bal[r];
      A.o_t_q[r] = A.t_q[r];
      A.o_t_qmask[r] = A.t_qmask[r];
      A.o_t_qbal[r] = A.t_qbal[r];
    } else {
      A.o_t_valid[r] = tv;
      A.o_t_slot[r] = ts;
      A.o_t_cmd[r] = tc;
      A.o_t_client[r] = tcl;
      A.o_t_mid[r] = tm;
      A.o_t_last[r] = tl;
      A.o_t_bal[r] = tb;
      A.o_t_q[r] = tq;
      A.o_t_qmask[r] = tqm;
      A.o_t_qbal[r] = tqb;
    }
  }
  __syncthreads();
  for (int l = t; l < Q * I.AR; l += blockDim.x) {
    const int q = l / I.AR, j = l - q * I.AR;
    const bool query = f_flag[q] & 2;
    const bool lvq =
        query ? (j < I.A && ((f_qm[q] >> j) & 1) == 0) : j == 0;
    put_lane(A.out, ob + l, (f_flag[q] & 1) && lvq,
             query ? I.a_base + j : f_dest[q], query ? T_QRY : T_ASSIGN,
             f_a[q], f_b[q], f_c[q], -1);
  }
  if (t < I.A) {
    const long long o = ob + Q * I.AR;
    put_lane(A.out, o + t,
             cd.ptick && ((cd.prom >> t) & 1) == 0 && !stalled, I.a_base + t,
             T_PREP, cd.bal, 0, 0, -1);
    put_lane(A.out, o + I.A + t, cd.htick && cd.dfront >= 0 && !stalled,
             I.a_base + t, T_CMT, cd.dfront, 0, 0, -1);
  }
  if (t < I.S)
    put_lane(A.out, ob + Q * I.AR + 2 * I.A + t,
             cd.htick && t != n && !stalled, I.s_base + t, T_HB, cd.bal, 0, 0,
             -1);
  if (t == 0) {
    const bool keep = stalled;
    A.o_next_slot[n] = keep ? A.next_slot[n] : wadd(cd.next_slot, n_do);
    A.o_bal[n] = keep ? A.bal[n] : cd.bal;
    A.o_seen[n] = keep ? A.seen[n] : cd.seen;
    A.o_leading[n] = keep ? A.leading[n] : cd.leading;
    A.o_electing[n] = keep ? A.electing[n] : cd.electing;
    A.o_prom[n] = keep ? A.prom[n] : cd.prom;
    A.o_cand_round[n] = keep ? A.cand_round[n] : cd.cand_round;
    A.o_rec_hi[n] = keep ? A.rec_hi[n] : cd.rec_hi;
    A.o_rec_next[n] = keep ? A.rec_next[n] : rec_next;
    A.o_heard[n] = keep ? A.heard[n] : cd.heard;
    A.o_deadline[n] = keep ? A.deadline[n] : cd.deadline;
    A.o_boff[n] = keep ? A.boff[n] : cd.boff;
    A.o_hb_last[n] = keep ? A.hb_last[n] : cd.hb_last;
    A.o_elect_last[n] = keep ? A.elect_last[n] : cd.elect_last;
    A.o_dfront[n] = keep ? A.dfront[n] : cd.dfront;
    A.o_won_count[n] = keep ? A.won_count[n] : cd.won_count;
    A.o_won_sum[n] = keep ? A.won_sum[n] : cd.won_sum;
    A.o_won_max[n] = keep ? A.won_max[n] : cd.won_max;
    A.o_bal_overflow[n] = keep ? A.bal_overflow[n] : cd.bal_overflow;
  }
  for (int j = t; j < C; j += blockDim.x)
    A.o_done_bits[crow + j] = stalled ? A.done_bits[crow + j] : s_done[j];
}

struct ProxyElectArgs {
  Lanes in;
  const u8 *p_valid, *p_learn;  // [n, Q]
  const int *p_slot, *p_cmd, *p_client, *p_mid, *p_last;
  const u8* p_acks;             // [n, Q, AR]
  const int* p_bal;             // [n, Q]
  const int* round;
  const u8* stall;
  Outbox out;                   // [n, Q * AR + Q + K]
  u8 *o_p_valid, *o_p_learn;
  int *o_p_slot, *o_p_cmd, *o_p_client, *o_p_mid, *o_p_last;
  u8* o_p_acks;
  int* o_p_bal;
  Evidence ev;                  // the conviction lanes' planes, or null
};
constexpr int kProxyElectPtrs = sizeof(ProxyElectArgs) / sizeof(void*);

struct ProxyElectInts {
  int n, K, Q, AR, A, R, rows, cols, S, s_base, a_base, r_base, retry, byz;
};

__global__ void proxy_elect_kernel(ProxyElectArgs A, ProxyElectInts I) {
  extern __shared__ int sm[];
  const int K = I.K, Q = I.Q, AR = I.AR;
  int* l_type = sm;              // [K]
  int* l_a = l_type + K;
  int* l_b = l_a + K;
  int* l_c = l_b + K;
  int* l_slot = l_c + K;         // [K] a & 0xFFF (the assign's slot)
  int* l_bal = l_slot + K;       // [K] the assign's ballot and client
  int* l_client = l_bal + K;
  int* s_slot = l_client + K;    // [Q] the rows' slot and ballot
  int* s_bal = s_slot + Q;
  int* s_rbr = s_bal + Q;        // [Q]
  int* s_asg = s_rbr + Q;        // [Q]
  u8* l_valid = (u8*)(s_asg + Q);  // [K]
  u8* l_asg = l_valid + K;       // [K] first assign of its slot
  u8* s_live = l_asg + K;        // [Q]
  u8* s_acks = s_live + Q;       // [Q * AR]
  u8* f_flag = s_acks + Q * AR;  // [Q] 1: due and live, 2: a learn row
  // with the adversary: the block's counters, the lanes' src, the rows'
  // commands
  int* c_conv = conv_region(f_flag + Q);
  int* l_src = c_conv + 6;
  int* s_cmd = l_src + K;
  // the rows' fan words (a, b, c) reuse s_slot, s_bal and s_rbr after
  // the assignments have read them
  int* f_a = s_slot;
  int* f_b = s_bal;
  int* f_c = s_rbr;
  __shared__ int s_warp[32];
  const int n = blockIdx.x, t = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const bool byz = I.byz != 0;
  const int rnd = A.round[0];
  const int L = Q * AR + Q + K + (byz ? K : 0);
  const long long ob = (long long)n * L;
  if (byz && t < 6) c_conv[t] = t < 2 ? 0 : -1;
  const long long abase = (long long)n * Q * AR;

  for (int j = t; j < Q * AR; j += blockDim.x) s_acks[j] = A.p_acks[abase + j];
  const long long r = (long long)n * Q + t;
  bool pv = false, pl = false;
  int ps = 0, pc = 0, pcl = 0, pm = 0, plast = 0, pb = 0;
  if (t < Q) {
    pv = A.p_valid[r];
    pl = A.p_learn[r];
    ps = A.p_slot[r];
    pc = A.p_cmd[r];
    pcl = A.p_client[r];
    pm = A.p_mid[r];
    plast = A.p_last[r];
    pb = A.p_bal[r];
    s_rbr[t] = 0;
    s_asg[t] = -1;
  }
  if (t < K) {
    const long long i = (long long)n * K + t;
    const int a = A.in.a[i];
    l_valid[t] = A.in.valid[i];
    l_type[t] = A.in.type[i];
    l_a[t] = a;
    l_b[t] = A.in.b[i];
    l_c[t] = A.in.c[i];
    l_slot[t] = a & 0xFFF;
    l_bal[t] = (a >> 24) & 0x3F;
    l_client[t] = (a >> 12) & 0xFFF;
    if (byz) l_src[t] = A.in.src[i];
  }
  if (byz && t < Q) s_cmd[t] = pc;
  __syncthreads();

  if (t < Q) {
    u8* acks = s_acks + t * AR;
    // acceptor acks (echoing the row's ballot) onto phase-2 rows, replica
    // acks onto learn rows
    if (pv) {
      const int want = pl ? T_EXEC : T_P2B;
      for (int k = 0; k < K; ++k) {
        const int j = l_b[k];
        if (l_valid[k] && l_type[k] == want && l_a[k] == ps && j >= 0 &&
            j < AR && (pl || l_c[k] == pb))
          acks[j] = 1;
      }
    }
    // every replica acked: retire the row, T_DONE to the assigning
    // leader (ballot % S)
    bool all_r = true;
    for (int j = 0; j < I.R; ++j) all_r = all_r && acks[j];
    const bool done = pv && pl && all_r;
    put_lane(A.out, ob + Q * AR + t, done && !stalled,
             I.s_base + mt_mod(pb, I.S), T_DONE, ps, 0, 0, -1);
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
    s_bal[t] = pb;
  }
  __syncthreads();

  // T_P2R: the grid fenced the row's ballot — drop the row, T_NLDR to
  // the stale leader (the highest fenced row ballot the lane hit, else 0)
  bool drop = false;
  if (t < Q && pv)
    for (int k = 0; k < K && !drop; ++k)
      drop = l_valid[k] && l_type[k] == T_P2R && l_a[k] == ps &&
             pb < l_c[k];
  if (t < K) {
    const bool rej = l_valid[t] && l_type[t] == T_P2R;
    bool hit_any = false;
    int stale = 0;
    for (int q = 0; q < Q; ++q) {
      const bool hit = rej && s_live[q] && s_slot[q] == l_a[t] &&
                       s_bal[q] < l_c[t];
      hit_any = hit_any || hit;
      const int v = hit ? s_bal[q] : 0;
      stale = q == 0 ? v : max(stale, v);
    }
    put_lane(A.out, ob + Q * AR + Q + t, hit_any && !stalled,
             I.s_base + mt_mod(stale, I.S), T_NLDR, l_c[t], 0, 0, -1);
    // new assignments: the first per slot
    l_asg[t] = first_of_key(l_valid, l_type, l_slot, t, T_ASSIGN);
  }
  __syncthreads();
  if (t < Q) {
    pv = pv && !drop;
    s_live[t] = pv;
  }
  __syncthreads();

  // with the adversary, on the rows left after retirement and the fence:
  // a first-per-slot assign that hits a live row of its slot at its ballot
  // with another command is an equivocation, one whose ballot lies outside
  // its source's residue class a stale ballot; either is convicted, leaves
  // the assigns before the hit, upgrade and allocation below, and is
  // NACKed to its source (lanes [Q * AR + Q + K, L))
  if (byz) {
    bool eq = false, sb = false;
    if (t < K && l_asg[t]) {
      for (int q = 0; q < Q && !eq; ++q)
        eq = s_live[q] && s_slot[q] == l_slot[t] && s_cmd[q] != l_b[t] &&
             s_bal[q] == l_bal[t];
      sb = mt_mod(l_bal[t], I.S) != l_src[t];
      conv_note(c_conv, eq, sb, l_src[t], l_slot[t], l_bal[t]);
    }
    if (t < K) {
      put_lane(A.out, ob + Q * AR + Q + K + t, (eq || sb) && !stalled,
               l_src[t], T_ERR_LANE, E_BYZANTINE, l_slot[t], l_bal[t], -1);
      if (eq || sb) l_asg[t] = 0;
    }
    __syncthreads();
  }

  // a higher-ballot assign frees the row it hits; a stale one drops
  bool asg = false;
  if (t < K && l_asg[t]) {
    asg = true;
    for (int q = 0; q < Q && asg; ++q)
      if (s_live[q] && s_slot[q] == l_slot[t] && s_bal[q] >= l_bal[t])
        asg = false;
  }
  if (t < Q && pv)
    for (int k = 0; k < K; ++k)
      if (l_asg[k] && l_slot[k] == ps && pb < l_bal[k]) {
        pv = false;
        break;
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
      pb = l_bal[k];
      plast = wsub(rnd, I.retry);
      for (int j = 0; j < AR; ++j) acks[j] = 0;
    }
    // fan-out lanes: row t, lane j -> acceptor j (phase 2a, c = the
    // row's ballot) or replica j (learn, a = client<<12 | slot); the
    // row's words go to shared memory for the block's coalesced write
    const bool due = pv && wsub(rnd, plast) >= I.retry;
    if (due) plast = rnd;
    f_flag[t] = (due && !stalled ? 1 : 0) | (pl ? 2 : 0);
    f_a[t] = pl ? (shl(pcl, 12) | ps) : ps;
    f_b[t] = pc;
    f_c[t] = pl ? pm : pb;
    if (stalled) {
      A.o_p_valid[r] = A.p_valid[r];
      A.o_p_learn[r] = A.p_learn[r];
      A.o_p_slot[r] = A.p_slot[r];
      A.o_p_cmd[r] = A.p_cmd[r];
      A.o_p_client[r] = A.p_client[r];
      A.o_p_mid[r] = A.p_mid[r];
      A.o_p_last[r] = A.p_last[r];
      A.o_p_bal[r] = A.p_bal[r];
    } else {
      A.o_p_valid[r] = pv;
      A.o_p_learn[r] = pl;
      A.o_p_slot[r] = ps;
      A.o_p_cmd[r] = pc;
      A.o_p_client[r] = pcl;
      A.o_p_mid[r] = pm;
      A.o_p_last[r] = plast;
      A.o_p_bal[r] = pb;
    }
  }
  if (byz && t == 0) conv_write(A.ev, c_conv, n, rnd, stalled);
  __syncthreads();
  for (int l = t; l < Q * AR; l += blockDim.x) {
    const int q = l / AR, j = l - q * AR;
    const bool learn = f_flag[q] & 2;
    put_lane(A.out, ob + l, (f_flag[q] & 1) && (learn ? j < I.R : j < I.A),
             (learn ? I.r_base : I.a_base) + j, learn ? T_LEARN : T_P2A,
             f_a[q], f_b[q], f_c[q], -1);
  }
  for (int j = t; j < Q * AR; j += blockDim.x)
    A.o_p_acks[abase + j] = stalled ? A.p_acks[abase + j] : s_acks[j];
}

struct AccElectArgs {
  Lanes in;
  const int* acc_cmd;   // [n, C]
  const u8* acc_has;    // [n, C]
  const int* promised;  // [n]
  const int* acc_bal;   // [n, C]
  const int *acc_hi, *acc_cmt;  // [n]
  const u8* stall;
  Outbox out;           // [n, K]
  int* o_acc_cmd;
  u8* o_acc_has;
  int* o_promised;
  int* o_acc_bal;
  int *o_acc_hi, *o_acc_cmt;
};
constexpr int kAccElectPtrs = sizeof(AccElectArgs) / sizeof(void*);

__global__ void acc_elect_kernel(AccElectArgs A, int K, int C, bool vec) {
  extern __shared__ int sm[];
  int* l_type = sm;               // [K]
  int* l_a = l_type + K;
  int* l_c = l_a + K;
  u8* l_valid = (u8*)(l_c + K);   // [K]
  u8* l_prep = l_valid + K;       // [K] the first prepare of its ballot
  u8* l_incap = l_prep + K;       // [K] the first T_P2A of its slot, in the log
  u8* l_ok = l_incap + K;         // [K] an accepted T_P2A
  __shared__ int s_pmax, s_prom, s_hi, s_cmt;
  const int n = blockIdx.x, chunk = blockIdx.y, t = threadIdx.x;
  const bool stalled = A.stall != nullptr && A.stall[n];
  const long long row = (long long)n * C;
  const int lo = chunk * kChunk, hi = min(C, lo + kChunk);
  {
    const int* src[2] = {A.acc_cmd, A.acc_bal};
    int* dst[2] = {A.o_acc_cmd, A.o_acc_bal};
    copy_rows<2>(src, dst, A.acc_has, A.o_acc_has, row, lo, hi, vec);
  }
  for (int k = t; k < K; k += blockDim.x) {
    const long long i = (long long)n * K + k;
    l_valid[k] = A.in.valid[i];
    l_type[k] = A.in.type[i];
    l_a[k] = A.in.a[i];
    l_c[k] = A.in.c[i];
  }
  __syncthreads();
  for (int k = t; k < K; k += blockDim.x) {
    l_prep[k] = first_of_key(l_valid, l_type, l_a, k, T_PREP);
    l_incap[k] = first_of_key(l_valid, l_type, l_a, k, T_P2A) &&
                 l_a[k] >= 0 && l_a[k] < C;
  }
  __syncthreads();
  if (t == 0) {
    // the round's highest prepare is promised; accepting b promises b
    int pmax = -1, cmt = -1;
    for (int k = 0; k < K; ++k) {
      if (l_prep[k]) pmax = max(pmax, l_a[k]);
      if (l_valid[k] && l_type[k] == T_CMT) cmt = max(cmt, l_a[k]);
    }
    pmax = max(A.promised[n], pmax);
    int prom = -1, ahi = -1;
    for (int k = 0; k < K; ++k) {
      l_ok[k] = l_incap[k] && l_c[k] >= pmax;
      if (l_ok[k]) {
        prom = max(prom, l_c[k]);
        ahi = max(ahi, l_a[k]);
      }
    }
    s_pmax = pmax;
    s_prom = max(pmax, prom);
    s_hi = max(A.acc_hi[n], ahi);
    s_cmt = max(A.acc_cmt[n], cmt);
  }
  __syncthreads();
  for (int k = t; k < K; k += blockDim.x) {
    const long long i = (long long)n * K + k;
    const int a = l_a[k];
    if (l_ok[k] && !stalled && a >= lo && a < hi) {
      A.o_acc_cmd[row + a] = A.in.b[i];
      A.o_acc_has[row + a] = 1;
      A.o_acc_bal[row + a] = l_c[k];
    }
    if (chunk != 0) continue;
    // the reply: a query reads the slot as this round's accepts leave it
    const int qs = mt_clip(a, 0, C - 1);
    int w = -1;
    for (int j = 0; j < K; ++j)
      if (l_ok[j] && l_a[j] == qs) w = j;
    const long long wi = (long long)n * K + (w < 0 ? 0 : w);
    const int g_cmd = w >= 0 ? A.in.b[wi] : A.acc_cmd[row + qs];
    const int g_bal = w >= 0 ? l_c[w] : A.acc_bal[row + qs];
    const bool g_has = (w >= 0 || A.acc_has[row + qs]) && a >= 0 && a < C;
    const bool ok2a = l_ok[k], nack = l_incap[k] && !ok2a;
    const bool prom_ok = l_prep[k] && a == s_pmax;
    const bool prom_rej = l_prep[k] && !prom_ok;
    const bool qry = l_valid[k] && l_type[k] == T_QRY;
    const int rtype = ok2a ? T_P2B
                           : (nack ? T_P2R
                                   : (prom_ok ? T_PROM
                                              : (prom_rej ? T_REJP : T_QVAL)));
    const int rb = qry ? g_cmd : (prom_rej ? 0 : n);
    const int qval_c = shl(n, 16) | (g_has ? wadd(g_bal, 1) : 0);
    const int prom_c = shl(wadd(s_cmt, 1), 13) | wadd(s_hi, 1);
    const int rc = ok2a ? l_c[k]
                        : ((nack || prom_rej) ? s_pmax
                                              : (prom_ok ? prom_c : qval_c));
    put_lane(A.out, i, (ok2a || nack || prom_ok || prom_rej || qry) && !stalled,
             A.in.src[i], rtype, a, rb, rc, -1);
  }
  if (chunk == 0 && t == 0) {
    A.o_promised[n] = stalled ? A.promised[n] : s_prom;
    A.o_acc_hi[n] = stalled ? A.acc_hi[n] : s_hi;
    A.o_acc_cmt[n] = stalled ? A.acc_cmt[n] : s_cmt;
  }
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
//       null); the outbox's ten fields ([n, Q * AR + Q], + K NACK lanes
//       with byz); the eight state outputs; the eight evidence planes in
//       and out (Z_KEYS; null without byz)
// ints: n, K, Q (proxy_slots), AR, A, R, rows, cols, leader, a_base,
//       r_base, retry, byz (the conviction lanes on)
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
                      I.Q + (size_t)I.Q * I.AR +
                      (I.byz ? conv_smem(I.K, I.Q) : 0);
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
// ints: n, K, C (log_cap), keys, AP, R, n_nodes (the cluster), vec, and
//       the learn word's slot_mask, cshift, cmask
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
  if (I.n < 1 || I.K < 1 || I.C < 1 || I.keys < 1 || I.R < 1 || I.AP < 0 ||
      I.cshift < 0 || I.cshift > 31)
    return cudaErrorInvalidValue;
  const dim3 grid(I.n, (I.C + kChunk - 1) / kChunk + 1);
  const size_t smem = (size_t)(2 * I.K + (2 * I.K + 3) / 4 + I.keys) *
                      sizeof(int);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  rep_kernel<<<grid, kRowThreads, smem, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}

// ptrs: the inbox's valid, src, mid, type, a, b, c; the 30 state leaves in
//       SEQ_ELECT_ALL's order (nodes/compartment.py); jit; round; stall (or
//       null); the outbox's ten fields ([n, Q * AR + 2A + S + K]); the 30
//       state outputs
// ints: n, K, Q (leader_slots), C (log_cap), keys, n_nodes (the cluster),
//       p_base, P, retry, S, A, AR, a_base, s_base, rows, cols,
//       etimeout (election_timeout_rounds), bal_width
MT_API int mt_compartment_sequencer_elect(void* const* p, int n_ptrs,
                                          const long long* v, int n_ints,
                                          void* stream) {
  constexpr int kInts = sizeof(SeqElectInts) / sizeof(int);
  if (mt_bad_args(n_ptrs, kSeqElectPtrs, n_ints, kInts))
    return cudaErrorInvalidValue;
  SeqElectArgs A;
  memcpy(&A, p, sizeof(A));
  SeqElectInts I;
  int* f = (int*)&I;
  for (int j = 0; j < kInts; ++j) f[j] = (int)v[j];
  const int rows = max(max(I.Q, I.K), max(I.A, I.S));
  const int threads = block_threads(rows);
  if (I.n < 1 || I.K < 1 || I.Q < 1 || I.P < 1 || I.keys < 1 || I.S < 2 ||
      I.A < 1 || I.A > 30 || I.AR < I.A || I.rows * I.cols != I.A ||
      I.C < 1 || I.bal_width < 1 || I.bal_width > 30 || threads > 1024)
    return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(7 * I.K + 5 * I.Q) * sizeof(int) + I.K + I.C + I.Q;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  seq_elect_kernel<<<I.n, threads, smem, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}

// ptrs: the inbox's valid, src, mid, type, a, b, c; p_valid, p_learn,
//       p_slot, p_cmd, p_client, p_mid, p_last, p_acks, p_bal; round; stall
//       (or null); the outbox's ten fields ([n, Q * AR + Q + K], + K NACK
//       lanes with byz); the nine state outputs; the eight evidence planes
//       in and out (Z_KEYS; null without byz)
// ints: n, K, Q (proxy_slots), AR, A, R, rows, cols, S, s_base, a_base,
//       r_base, retry, byz (the conviction lanes on)
MT_API int mt_compartment_proxy_elect(void* const* p, int n_ptrs,
                                      const long long* v, int n_ints,
                                      void* stream) {
  constexpr int kInts = sizeof(ProxyElectInts) / sizeof(int);
  if (mt_bad_args(n_ptrs, kProxyElectPtrs, n_ints, kInts))
    return cudaErrorInvalidValue;
  ProxyElectArgs A;
  memcpy(&A, p, sizeof(A));
  ProxyElectInts I;
  int* f = (int*)&I;
  for (int j = 0; j < kInts; ++j) f[j] = (int)v[j];
  const int threads = block_threads(I.Q > I.K ? I.Q : I.K);
  if (I.n < 1 || I.K < 1 || I.Q < 1 || I.AR < I.A || I.AR < I.R ||
      I.rows * I.cols != I.A || I.S < 2 || threads > 1024)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(7 * I.K + 4 * I.Q) * sizeof(int) + 2 * I.K +
                      2 * I.Q + (size_t)I.Q * I.AR +
                      (I.byz ? conv_smem(I.K, I.Q) : 0);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  proxy_elect_kernel<<<I.n, threads, smem, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}

// ptrs: the inbox's valid, src, mid, type, a, b, c; acc_cmd, acc_has,
//       promised, acc_bal, acc_hi, acc_cmt; stall (or null); the outbox's
//       ten fields ([n, K]); the six state outputs
// ints: n, K, C (log_cap), vec (C % 16 == 0 and the [n, C] planes 16-byte
//       aligned)
MT_API int mt_compartment_acceptor_elect(void* const* p, int n_ptrs,
                                         const long long* v, int n_ints,
                                         void* stream) {
  if (mt_bad_args(n_ptrs, kAccElectPtrs, n_ints, 4))
    return cudaErrorInvalidValue;
  AccElectArgs A;
  memcpy(&A, p, sizeof(A));
  const int n = (int)v[0], K = (int)v[1], C = (int)v[2];
  if (n < 1 || K < 1 || C < 1) return cudaErrorInvalidValue;
  const dim3 grid(n, (C + kChunk - 1) / kChunk);
  const size_t smem = (size_t)3 * K * sizeof(int) + 4 * K;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  acc_elect_kernel<<<grid, kRowThreads, smem, (cudaStream_t)stream>>>(
      A, K, C, v[3] != 0);
  return cudaGetLastError();
}
