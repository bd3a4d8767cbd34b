// K10 raft_step: one round of the Raft node program serving lin-kv.
//
// Replaces maelstrom_tpu/nodes/raft.py:RaftProgram.edge_step (:220-675),
// with the JAX round's freeze of killed and paused nodes fused in
// (maelstrom_tpu/sim.py:_freeze_nodes, :94-112, and the output masks at
// :476-488): term catch-up, the election timer with its jitter, votes
// (the first eligible edge wins), AppendEntries ingest under the
// contiguous-prefix rule, the AE replies, the commit advance (the N//2-th
// largest of match and the own log end), client appends, proxying and
// sheds, the in-order apply chain of K steps (a CAS reads the write before
// it), and the outbound lanes with their [D, E] entry window. The node
// rows are F clusters of N nodes (F = 1 for one cluster): row r is node
// r % N of cluster r / N, whose round and program key are round[r / N]
// and keys[r / N]; neighbour ids are cluster-local, as raft compares them
// with its own id.
//
// The election jitter, randint(fold_in(k2, 17), (N,), 0, election)
// (raft.py:260-261), is drawn here with the device threefry of
// common.cuh: fold_in is the hash of counter (0, 17), randint's two
// streams the bits of split(key, 2) at counter (0, node), combined modulo
// the span in uint32 arithmetic as prng.py `randint` does.
//
// Order hazards, kept as the JAX version has them: last_term, the AE
// prev_term check, the entries' conflict check and the commit advance's
// best_term read the pre-round log (the input planes); the apply gather,
// the AE prev_term sent and the entry window read the post-append log
// (the output planes, which this thread alone writes). The kernel never
// updates its inputs, so a rolled-back scan chunk replays from them.
// Scatters are JAX's mode="drop": a position in [-C, 0) counts from the
// end of the row, one outside [-C, C) is dropped.
//
// Bound: bytes. A node reads and writes its state planes, 36 + N + 12 C
// + 8 D + 4 KEYS bytes each way (log_a/b/c [C], kv [KEYS], next and match
// [D], votes [N], nine scalars), its D * L lanes in and out (17 bytes a
// lane) and its K client slots (29 bytes read, 37 written): 9,554 bytes a
// node at the bench shape (N 5, D 4, C 256, KEYS 256, L 7, K 4), 477.7 MB
// for 10,000 clusters, 0.143 ms at 3.35 TB/s. The threefry hashes (5 a
// node) and the branchy per-node logic are far below the int32 rate.
// Design: one thread a node, plain and right. A block first copies its
// nodes' log and kv rows into the output planes (contiguous, so the copy
// is coalesced), then each thread runs its node's step, writing the few
// changed log and kv cells in place of its own rows. A stalled node runs
// the step for the lane and reply fields (the JAX round masks only their
// valid bits) and then writes its old state back.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int T_ERR = 1;
constexpr int T_READ = 10, T_READ_OK = 11, T_WRITE = 12, T_WRITE_OK = 13;
constexpr int T_CAS = 14, T_CAS_OK = 15, T_TXN = 16, T_TXN_OK = 17;
constexpr int T_RV = 20, T_RV_REPLY = 21, T_AE = 22, T_AE_REPLY = 23;
constexpr int T_PROXY = 24, T_ENTRY = 25;
constexpr int OP_NOOP = 0, OP_WRITE = 1, OP_CAS = 2, OP_READ = 3,
              OP_TXN = 4;
constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;
// per-node arrays live in registers and local memory; edge and client
// masks are bit sets (nodes/raft.py MAX_N, MAX_D, MAX_E, MAX_K)
constexpr int kMaxN = 32, kMaxD = 32, kMaxE = 15, kMaxK = 64;
constexpr int kThreads = 128;   // nodes a block

// pointer arguments, in the order the Python wrapper passes them
struct RaftArgs {
  const int *role, *term, *voted_for;
  const u8* votes;
  const int *log_a, *log_b, *log_c, *log_len, *commit, *applied, *next,
      *match, *kv, *deadline, *leader_hint, *log_overflow;
  const u8* e_valid;
  const int *e_type, *e_a, *e_b, *e_c;
  const u8* c_valid;
  const int *c_src, *c_due, *c_mid, *c_type, *c_a, *c_b, *c_c;
  const int *neighbors, *round;
  const unsigned* keys;
  const u8* stall;  // [F * N] killed or paused rows, or null
  int *o_role, *o_term, *o_voted_for;
  u8* o_votes;
  int *o_log_a, *o_log_b, *o_log_c, *o_log_len, *o_commit, *o_applied,
      *o_next, *o_match, *o_kv, *o_deadline, *o_leader_hint,
      *o_log_overflow;
  u8* oe_valid;
  int *oe_type, *oe_a, *oe_b, *oe_c;
  u8* oc_valid;
  int *oc_src, *oc_dest, *oc_due, *oc_mid, *oc_reply_to, *oc_type, *oc_a,
      *oc_b, *oc_c;
};
constexpr int kRaftPtrs = sizeof(RaftArgs) / sizeof(void*);

struct Dims {
  long long R;
  int N, D, L, E, C, KEYS, K, election, heartbeat;
};

// int32 arithmetic that wraps, as XLA's and torch's does
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int shl(int x, int s) {
  return (int)((unsigned)x << s);
}

// a scatter position under mode="drop": the cell, or -1 when dropped
__device__ __forceinline__ int drop_pos(int p, int C) {
  if (p < 0) p += C;
  return p >= 0 && p < C ? p : -1;
}

// randint(fold_in(key, 17), (N,), 0, election)[node]
__device__ int election_jitter(const unsigned* key, int node, int election) {
  unsigned r0 = 0, r1 = 17;
  mt_threefry2x32(key[0], key[1], r0, r1);
  unsigned a0 = 0, a1 = 0, b0 = 0, b1 = 1;
  mt_threefry2x32(r0, r1, a0, a1);
  mt_threefry2x32(r0, r1, b0, b1);
  unsigned h0 = 0, h1 = (unsigned)node, l0 = 0, l1 = (unsigned)node;
  mt_threefry2x32(a0, a1, h0, h1);
  mt_threefry2x32(b0, b1, l0, l1);
  const unsigned hi = h0 ^ h1, lo = l0 ^ l1;
  const unsigned span = election > 0 ? (unsigned)election : 1u;
  unsigned mult = 65536u % span;
  mult = (mult * mult) % span;
  return (int)(((hi % span) * mult + lo % span) % span);
}

__device__ void copy_ints(const int* __restrict__ src, int* __restrict__ dst,
                          long long n) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0 && (n & 3) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void raft_kernel(RaftArgs A, Dims d) {
  const int C = d.C, KEYS = d.KEYS;
  const long long r0 = (long long)blockIdx.x * kThreads;
  {
    const long long rows = d.R - r0 < kThreads ? d.R - r0 : kThreads;
    copy_ints(A.log_a + r0 * C, A.o_log_a + r0 * C, rows * C);
    copy_ints(A.log_b + r0 * C, A.o_log_b + r0 * C, rows * C);
    copy_ints(A.log_c + r0 * C, A.o_log_c + r0 * C, rows * C);
    copy_ints(A.kv + r0 * KEYS, A.o_kv + r0 * KEYS, rows * KEYS);
  }
  __syncthreads();
  const long long r = r0 + threadIdx.x;
  if (r >= d.R) return;

  const int N = d.N, D = d.D, L = d.L, E = d.E, K = d.K;
  const long long f = r / N;
  const int me = (int)(r % N);
  const int rnd = A.round[f];
  const int* nb = A.neighbors + (long long)me * D;
  const bool stalled = A.stall != nullptr && A.stall[r] != 0;
  const int* la0 = A.log_a + r * C;  // the pre-round log
  int* la = A.o_log_a + r * C;       // the post-append log
  int* lb = A.o_log_b + r * C;
  int* lc = A.o_log_c + r * C;
  int* kv = A.o_kv + r * KEYS;
  const long long e0 = r * D * L;    // lane (d, l) at e0 + d * L + l

  int role = A.role[r], term = A.term[r], voted = A.voted_for[r];
  unsigned votes = 0;
  for (int j = 0; j < N; ++j)
    if (A.votes[r * N + j]) votes |= 1u << j;
  const int log_len0 = A.log_len[r];
  int log_len = log_len0, commit = A.commit[r], applied = A.applied[r];
  int deadline = A.deadline[r], hint = A.leader_hint[r];
  int overflow = A.log_overflow[r];
  int nxt_[kMaxD], mat_[kMaxD];
  for (int dd = 0; dd < D; ++dd) {
    nxt_[dd] = A.next[r * D + dd];
    mat_[dd] = A.match[r * D + dd];
  }

  // inbound decode and term catch-up (Raft section 5.1)
  unsigned is_rv = 0, is_ae = 0, is_rvr = 0, is_aer = 0, is_prx = 0;
  int seen_req = 0, seen_rep = 0;
  for (int dd = 0; dd < D; ++dd) {
    const long long i = e0 + (long long)dd * L;
    const unsigned bit = 1u << dd;
    const bool v0 = A.e_valid[i] != 0, v1 = A.e_valid[i + 1] != 0;
    const int t0 = A.e_type[i], t1 = A.e_type[i + 1];
    if (v0 && t0 == T_RV) is_rv |= bit;
    if (v0 && t0 == T_AE) is_ae |= bit;
    if (v1 && t1 == T_RV_REPLY) is_rvr |= bit;
    if (v1 && t1 == T_AE_REPLY) is_aer |= bit;
    if (A.e_valid[i + 2] && A.e_type[i + 2] == T_PROXY) is_prx |= bit;
    const int x0 = ((is_rv | is_ae) & bit) ? A.e_a[i] : 0;
    const int x1 = ((is_rvr | is_aer) & bit) ? A.e_a[i + 1] : 0;
    seen_req = dd == 0 || x0 > seen_req ? x0 : seen_req;
    seen_rep = dd == 0 || x1 > seen_rep ? x1 : seen_rep;
  }
  const int terms_seen = seen_req > seen_rep ? seen_req : seen_rep;
  if (terms_seen > term) {
    term = terms_seen;
    role = FOLLOWER;
    voted = -1;
  }

  // election timer
  const int new_deadline =
      wadd(wadd(rnd, d.election), election_jitter(A.keys + 2 * f, me,
                                                  d.election));
  const bool timed_out = role != LEADER && rnd >= deadline;
  if (timed_out) {
    term = wadd(term, 1);
    role = CANDIDATE;
    voted = me;
    votes = 0;
    deadline = new_deadline;
    hint = -1;
  }
  const int last_idx = wadd(log_len0, -1);
  const int last_term =
      last_idx >= 0 ? la0[mt_clip(last_idx, 0, C - 1)] >> 16 : 0;

  // votes (5.2): at most one grant a round, to the first eligible edge
  unsigned elig = 0;
  for (int dd = 0; dd < D; ++dd) {
    const long long i = e0 + (long long)dd * L;
    if (!((is_rv >> dd) & 1u) || A.e_a[i] != term) continue;
    const int rb = A.e_b[i], rc = A.e_c[i];
    const bool log_ok = rc > last_term || (rc == last_term && rb >= last_idx);
    const bool can_vote = voted < 0 || voted == nb[dd];
    if (log_ok && can_vote) elig |= 1u << dd;
  }
  const unsigned grant = elig & (0u - elig);  // the lowest set bit
  if (elig) {
    voted = nb[__ffs(elig) - 1];
    deadline = new_deadline;
  }

  // granted replies; the self-vote is implicit
  unsigned vadd = 0;
  for (int dd = 0; dd < D; ++dd) {
    const long long i = e0 + (long long)dd * L + 1;
    if (((is_rvr >> dd) & 1u) && A.e_a[i] == term && A.e_b[i] > 0 &&
        nb[dd] >= 0 && nb[dd] < N)
      vadd |= 1u << nb[dd];
  }
  const bool cand_now = role == CANDIDATE;
  votes = cand_now ? votes | vadd : 0;
  if (cand_now && __popc(votes) + 1 > N / 2) {
    role = LEADER;
    for (int dd = 0; dd < D; ++dd) {
      nxt_[dd] = log_len0;
      mat_[dd] = -1;
    }
  }

  // append entries, follower side (5.3)
  unsigned cur = 0;
  for (int dd = 0; dd < D; ++dd)
    if (((is_ae >> dd) & 1u) && A.e_a[e0 + (long long)dd * L] == term)
      cur |= 1u << dd;
  if (cur) {
    hint = __ffs(cur) - 1;
    deadline = new_deadline;
    if (role == CANDIDATE) role = FOLLOWER;
  }
  unsigned accept = 0;
  for (int dd = 0; dd < D; ++dd) {
    if (!((cur >> dd) & 1u)) continue;
    const int b = A.e_b[e0 + (long long)dd * L];
    const int prev_idx = (b >> 16) - 1, prev_term = b & 0xFFFF;
    const bool match = prev_idx < 0 ||
        (prev_idx < log_len0 &&
         (la0[mt_clip(prev_idx, 0, C - 1)] >> 16) == prev_term);
    if (match) accept |= 1u << dd;
  }
  const int acc_d = accept ? __ffs(accept) - 1 : 0;
  const long long ia = e0 + (long long)acc_d * L;
  const int acc_prev = (A.e_b[ia] >> 16) - 1;
  const int acc_cnt = A.e_c[ia] & 0xF;
  // only a contiguous prefix of the arrived entries may append
  int contig_cnt = 0, max_end = 0;
  bool conflict = false, bad_before = false;
  for (int e = 0; e < E; ++e) {
    const long long ie = ia + 3 + e;
    const bool present = accept && A.e_valid[ie] && A.e_type[ie] == T_ENTRY;
    const bool expected = accept && e < acc_cnt;
    const int pos = wadd(acc_prev, 1 + e);
    const bool in_cap = present && !bad_before && expected && pos < C;
    if (expected && !present) bad_before = true;
    const int end = in_cap ? wadd(pos, 1) : 0;
    max_end = e == 0 || end > max_end ? end : max_end;
    if (!in_cap) continue;
    ++contig_cnt;
    const int ea = A.e_a[ie];
    if (pos < log_len0 && (la0[mt_clip(pos, 0, C - 1)] >> 16) != (ea >> 16))
      conflict = true;
    const int p = drop_pos(pos, C);
    if (p >= 0) {
      la[p] = ea;
      lb[p] = A.e_b[ie];
      lc[p] = A.e_c[ie];
    }
  }
  if (accept) {
    const int new_len = max_end > log_len0 ? max_end : log_len0;
    const int window_end = wadd(acc_prev, 1 + contig_cnt);
    log_len = conflict && window_end < new_len ? window_end : new_len;
    const int acc_commit = (A.e_c[ia] >> 4) - 1;
    const int verified = wadd(acc_prev, contig_cnt);
    const int upto = acc_commit < verified ? acc_commit : verified;
    commit = upto > commit ? upto : commit;
  }

  // AE replies, leader side
  for (int dd = 0; dd < D; ++dd) {
    const long long i = e0 + (long long)dd * L + 1;
    if (!((is_aer >> dd) & 1u) || A.e_a[i] != term || role != LEADER)
      continue;
    const int rb = A.e_b[i], rc = A.e_c[i];
    if (rb > 0) {
      mat_[dd] = rc > mat_[dd] ? rc : mat_[dd];
      nxt_[dd] = wadd(rc, 1) > nxt_[dd] ? wadd(rc, 1) : nxt_[dd];
    } else if (rb == 0) {
      const int a = wadd(nxt_[dd], -1), b = wadd(rc, 1);
      nxt_[dd] = mt_clip(a < b ? a : b, 0, C);
    }
  }

  // commit advance: the (N//2)-th largest of the matches and the own log
  // end, if that entry is of the current term (5.4.2)
  int repl[kMaxD + 1];
  for (int dd = 0; dd < D; ++dd) repl[dd] = mat_[dd];
  repl[D] = wadd(log_len, -1);
  for (int i = 1; i <= D; ++i) {  // insertion sort, descending
    const int x = repl[i];
    int j = i - 1;
    while (j >= 0 && repl[j] < x) {
      repl[j + 1] = repl[j];
      --j;
    }
    repl[j + 1] = x;
  }
  const int best = repl[N / 2];
  const int best_term = best >= 0 ? la0[mt_clip(best, 0, C - 1)] >> 16 : -1;
  const bool is_leader = role == LEADER;
  if (is_leader && best_term == term && best > commit) commit = best;

  // client requests: a leader appends them, a non-leader proxies its
  // first one toward its known leader and sheds the others
  int proxy_slot = -1, proxy_a = 0, proxy_b = 0, proxy_c = 0;
  unsigned long long want = 0;
  {
    const int base = log_len;
    int wished = 0, done = 0, over = 0;
    for (int k = 0; k < K; ++k) {
      const long long ci = r * K + k;
      const int ct = A.c_type[ci], ca = A.c_a[ci];
      const bool creq = A.c_valid[ci] &&
          (ct == T_READ || ct == T_WRITE || ct == T_CAS || ct == T_TXN);
      if (!creq) continue;
      const int op = ct == T_WRITE ? OP_WRITE : ct == T_CAS ? OP_CAS
          : ct == T_TXN ? OP_TXN : OP_READ;
      const bool txn = ct == T_TXN;
      const int keyk = txn ? 0 : mt_clip(ca, 0, KEYS - 1);
      const int v1 = txn ? (ca >> 8) & 0xFF
          : (ct == T_WRITE || ct == T_CAS) ? wadd(A.c_b[ci], 1) : 0;
      const int v2 = txn ? ca & 0xFF
          : ct == T_CAS ? wadd(A.c_c[ci], 1) : 0;
      const int client = mt_clip(wadd(A.c_src[ci], -N), 0, 0xFFFF);
      const int eb = shl(client, 16) | shl(mt_clip(v1, 0, 0xFF), 8) |
          mt_clip(v2, 0, 0xFF);
      if (is_leader) {
        const int pos = wadd(base, wished++);
        if (pos < C) {
          ++done;
          const int p = drop_pos(pos, C);
          if (p >= 0) {
            la[p] = shl(term, 16) | shl(keyk, 4) | op;
            lb[p] = eb;
            lc[p] = A.c_mid[ci];
          }
        } else {
          ++over;
        }
      } else {
        if (proxy_slot < 0) {
          proxy_slot = k;
          proxy_a = shl(keyk, 4) | op;
          proxy_b = eb;
          proxy_c = A.c_mid[ci];
        }
        want |= 1ull << k;
      }
    }
    log_len = wadd(log_len, done);
    overflow = wadd(overflow, over);
  }
  // a request this node can neither serve nor forward fails with error 11
  const unsigned long long shed =
      hint < 0 ? want : want & ~(1ull << (proxy_slot < 0 ? 0 : proxy_slot));

  // proxied requests arriving at the leader: one append an edge
  if (is_leader) {
    const int base = log_len;
    int wished = 0, done = 0, over = 0;
    for (int dd = 0; dd < D; ++dd) {
      if (!((is_prx >> dd) & 1u)) continue;
      const long long i = e0 + (long long)dd * L + 2;
      const int pos = wadd(base, wished++);
      if (pos >= C) {
        ++over;
        continue;
      }
      ++done;
      const int p = drop_pos(pos, C);
      if (p < 0) continue;
      const int pa = A.e_a[i];
      la[p] = shl(term, 16) | shl((pa >> 4) & 0xFFF, 4) | (pa & 0xF);
      lb[p] = A.e_b[i];
      lc[p] = A.e_c[i];
    }
    log_len = wadd(log_len, done);
    overflow = wadd(overflow, over);
  }

  // apply in log order: applied+1+j while committed; the client reply of
  // step j goes to slot j (replies only on leaders, sheds only on
  // non-leaders: disjoint)
  const int start = wadd(applied, 1);
  for (int j = 0; j < K; ++j) {
    const int idx = wadd(start, j);
    const bool active = idx <= commit;
    const int pj = mt_clip(idx, 0, C - 1);
    const int ea = la[pj], eb = lb[pj], ec = lc[pj];
    const int key = (ea >> 4) & 0xFFF, op = ea & 0xF;
    const int v1 = (eb >> 8) & 0xFF, v2 = eb & 0xFF;
    const int sk = mt_clip(key, 0, KEYS - 1);
    const int cur_v = kv[sk];
    const bool cas_ok = op == OP_CAS && cur_v == v1 && cur_v > 0;
    if (active && (op == OP_WRITE || cas_ok)) kv[sk] = op == OP_WRITE ? v1
                                                                      : v2;
    if (active) applied = idx;
    const bool say = active && is_leader && op != OP_NOOP;
    const int rtype = op == OP_TXN ? T_TXN_OK
        : op == OP_READ ? (cur_v > 0 ? T_READ_OK : T_ERR)
        : op == OP_WRITE ? T_WRITE_OK : cas_ok ? T_CAS_OK : T_ERR;
    const int ra = op == OP_TXN ? idx
        : op == OP_READ ? (cur_v > 0 ? cur_v : 20)
        : (op == OP_CAS && !cas_ok) ? (cur_v > 0 ? 22 : 20) : 0;
    const long long co = r * K + j;
    const bool sh = (shed >> j) & 1ull;
    A.oc_valid[co] = (say || sh) && !stalled;
    A.oc_src[co] = me;
    A.oc_dest[co] = sh ? A.c_src[co] : wadd(N, eb >> 16);
    A.oc_due[co] = A.c_due[co];
    A.oc_mid[co] = A.c_mid[co];
    A.oc_reply_to[co] = sh ? A.c_mid[co] : ec;
    A.oc_type[co] = sh ? T_ERR : rtype;
    A.oc_a[co] = sh ? 11 : ra;
    A.oc_b[co] = 0;
    A.oc_c[co] = 0;
  }

  // outbound lanes: lane 0 vote requests or AE headers, lane 1 vote and
  // append results (acking only the contiguously appended prefix), lane 2
  // the proxied request toward the leader edge, then the entry window
  const bool beat = mt_mod(rnd, d.heartbeat) == 0;
  for (int dd = 0; dd < D; ++dd) {
    const long long o = e0 + (long long)dd * L;
    const bool eok = nb[dd] >= 0;
    const int nxt = nxt_[dd] < log_len ? nxt_[dd] : log_len;
    const int cnt = mt_clip(wadd(log_len, -nxt), 0, E);
    const bool send_rv = timed_out && eok;
    const bool send_ae = is_leader && eok && (cnt > 0 || beat);
    const int prev_idx = wadd(nxt, -1);
    const int prev_term =
        prev_idx >= 0 ? la[mt_clip(prev_idx, 0, C - 1)] >> 16 : 0;
    A.oe_valid[o] = (send_rv || send_ae) && !stalled;
    A.oe_type[o] = send_rv ? T_RV : T_AE;
    A.oe_a[o] = term;
    A.oe_b[o] = send_rv ? last_idx : shl(wadd(prev_idx, 1), 16) | prev_term;
    A.oe_c[o] = send_rv ? last_term : shl(wadd(commit, 1), 4) | cnt;

    const bool rv = (is_rv >> dd) & 1u, acc = (accept >> dd) & 1u;
    const int ae_prev = (A.e_b[o] >> 16) - 1;
    const int lend = wadd(log_len, -1), hint_len = wadd(ae_prev, -1);
    const int match_val = acc ? wadd(acc_prev, contig_cnt)
                              : (lend < hint_len ? lend : hint_len);
    A.oe_valid[o + 1] = (rv || ((cur >> dd) & 1u)) && !stalled;
    A.oe_type[o + 1] = rv ? T_RV_REPLY : T_AE_REPLY;
    A.oe_a[o + 1] = term;
    A.oe_b[o + 1] = rv ? (int)((grant >> dd) & 1u) : (int)acc;
    A.oe_c[o + 1] = rv ? 0 : match_val;

    A.oe_valid[o + 2] = proxy_slot >= 0 && hint == dd && eok && !stalled;
    A.oe_type[o + 2] = T_PROXY;
    A.oe_a[o + 2] = proxy_a;
    A.oe_b[o + 2] = proxy_b;
    A.oe_c[o + 2] = proxy_c;

    for (int e = 0; e < E; ++e) {
      const int pe = mt_clip(wadd(nxt, e), 0, C - 1);
      A.oe_valid[o + 3 + e] = send_ae && e < cnt && !stalled;
      A.oe_type[o + 3 + e] = T_ENTRY;
      A.oe_a[o + 3 + e] = la[pe];
      A.oe_b[o + 3 + e] = lb[pe];
      A.oe_c[o + 3 + e] = lc[pe];
    }
  }

  if (stalled) {  // a killed or paused node keeps its state
    for (int c = 0; c < C; ++c) {
      la[c] = la0[c];
      lb[c] = A.log_b[r * C + c];
      lc[c] = A.log_c[r * C + c];
    }
    for (int k = 0; k < KEYS; ++k) kv[k] = A.kv[r * KEYS + k];
    role = A.role[r];
    term = A.term[r];
    voted = A.voted_for[r];
    votes = 0;
    for (int j = 0; j < N; ++j)
      if (A.votes[r * N + j]) votes |= 1u << j;
    log_len = log_len0;
    commit = A.commit[r];
    applied = A.applied[r];
    deadline = A.deadline[r];
    hint = A.leader_hint[r];
    overflow = A.log_overflow[r];
    for (int dd = 0; dd < D; ++dd) {
      nxt_[dd] = A.next[r * D + dd];
      mat_[dd] = A.match[r * D + dd];
    }
  }
  A.o_role[r] = role;
  A.o_term[r] = term;
  A.o_voted_for[r] = voted;
  for (int j = 0; j < N; ++j) A.o_votes[r * N + j] = (votes >> j) & 1u;
  A.o_log_len[r] = log_len;
  A.o_commit[r] = commit;
  A.o_applied[r] = applied;
  for (int dd = 0; dd < D; ++dd) {
    A.o_next[r * D + dd] = nxt_[dd];
    A.o_match[r * D + dd] = mat_[dd];
  }
  A.o_deadline[r] = deadline;
  A.o_leader_hint[r] = hint;
  A.o_log_overflow[r] = overflow;
}

}  // namespace

// ptrs: the fields of RaftArgs in order: the 16 state planes in
//       (nodes/raft.py STATE_KEYS; leaves [F * N, ...]), edge_in valid,
//       type, a, b, c [F * N, D, L], client_in valid, src, due, mid, type,
//       a, b, c [F * N, K], the local neighbour table [N, D], round i32
//       [F], keys uint32 [F, 2], stall [F * N] or null, the 16 state
//       planes out, edge_out [F * N, D, L] and client_out [F * N, K] (the
//       ten Msgs fields)
// ints: F * N, N, D, L, E, C, KEYS, K, election, heartbeat
MT_API int mt_raft_step(void* const* p, int n_ptrs, const long long* v,
                        int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kRaftPtrs, n_ints, 10))
    return cudaErrorInvalidValue;
  RaftArgs args;
  memcpy(&args, p, sizeof(args));
  Dims d;
  d.R = v[0];
  d.N = (int)v[1];
  d.D = (int)v[2];
  d.L = (int)v[3];
  d.E = (int)v[4];
  d.C = (int)v[5];
  d.KEYS = (int)v[6];
  d.K = (int)v[7];
  d.election = (int)v[8];
  d.heartbeat = (int)v[9];
  if (d.N < 1 || d.N > kMaxN || d.D < 1 || d.D > kMaxD || d.E < 1 ||
      d.E > kMaxE || d.L != 3 + d.E || d.K < 0 || d.K > kMaxK || d.C < 1 ||
      d.KEYS < 1 || d.heartbeat < 1 || d.election < 1 || d.R < 0 ||
      d.R % d.N != 0)
    return cudaErrorInvalidValue;
  if (d.R == 0) return cudaSuccess;
  raft_kernel<<<mt_blocks(d.R, kThreads), kThreads, 0,
                (cudaStream_t)stream>>>(args, d);
  return cudaGetLastError();
}
