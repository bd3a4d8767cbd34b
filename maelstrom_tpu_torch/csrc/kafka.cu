// K14 kafka_step: one round of the kafka replicated-log node program on
// the edge channels, classic and consumer-group mode (G > 0).
//
// Replaces maelstrom_tpu/nodes/kafka.py:KafkaProgram.edge_step (:246-521)
// with _assign_members and _pack_assign (:529-560) and the round's freeze
// (maelstrom_tpu/sim.py:94-112). State: log [N, K, C], log_len [N, K],
// peer_len [N, D, K], committed [N, K], log_overflow [N]; in group mode
// gactive [N, G, M] (bool), gseen [N, G, M], ggen [N, G] and gcommitted
// [N, G, K]. A round
//   1. takes each key's lowest-index edge whose replication offer lands
//      exactly at the node's length (jnp.argmax's first maximum) and
//      appends it; records the neighbours' advertised lengths;
//   2. evicts group members whose heartbeat is older than the session
//      timeout (every row) and bumps the generations;
//   3. walks the A inbox slots in order, each reading what the one before
//      wrote: owner sends append (error 11 misrouted, 14 log full),
//      coordinator commits max into the committed row (every slot maxes
//      with -1 at least, as the JAX scatter-max does), lists and polls
//      pack 16-bit fields; in group mode subscribes join, commits are
//      fenced against the pre-join generation and membership, fenced
//      commits rejoin, keys are assigned to the member of rank k mod
//      count, banked group commits max the member's own keys, fetches
//      count the entries past the cursor;
//   4. offers each neighbour, per key, the entry at the offset it last
//      advertised (valid when it trails, when the length changed this
//      round, or on the beat).
//
// Out of place: the wrapper copies the log into o_log (a device copy
// beside the kernel) and the kernel appends there, so a rolled-back scan
// chunk replays from unchanged inputs. Every other state leaf is written
// whole. The optional stall plane [N]: a stalled node writes its old
// state (the appended log cells are written back) and no valid edge or
// client row; every other output field is what the unstalled step
// computes.
//
// Design: one block a node. Threads over the keys take the offers
// (phase 1), threads over G x M evict (phase 2); warp 0 walks the slots
// with every lane computing the same values from registers, lane 0
// writing, and the membership rank as ballots and popcounts over the M
// members (phase 3); threads over D x K fill the lanes (phase 4).
#include <cstring>

#include "common.cuh"

namespace {

constexpr int T_ERROR = 1;
constexpr int T_SEND = 10, T_SEND_OK = 11, T_POLL = 12, T_POLL_OK = 13;
constexpr int T_COMMIT = 14, T_COMMIT_OK = 15, T_LIST = 16, T_LIST_OK = 17;
constexpr int T_REPL = 20;
constexpr int T_SUB = 30, T_SUB_OK = 31, T_FETCH = 32, T_FETCH_OK = 33;
constexpr int T_GCOMMIT = 34, T_GCOMMIT_OK = 35, T_REBAL = 36;
constexpr int T_GLIST = 37, T_GLIST_OK = 38;
constexpr int MAX_PACK_KEYS = 6, BANK_KEYS = 4;
constexpr int MAXK = 8, MAXG = 16, MAXA = 32, MAXCH = 8;  // M <= 256

// pointer arguments, in the order the Python wrapper passes them
struct StepArgs {
  const int *log, *log_len, *peer_len, *committed, *log_overflow;
  const u8* gactive;  // [N, G, M]; the four group planes null when G == 0
  const int *gseen, *ggen, *gcommitted;
  const u8* e_valid;  // [N, D, K]
  const int *e_type, *e_a, *e_b, *e_c;
  const u8* c_valid;  // [N, A]
  const int *c_src, *c_due, *c_mid, *c_type, *c_a, *c_b, *c_c;
  const int *neighbors, *round;  // [N, D], scalar
  const u8* stall;               // [N] or null
  int *o_log, *o_log_len, *o_peer_len, *o_committed, *o_log_overflow;
  u8* o_gactive;
  int *o_gseen, *o_ggen, *o_gcommitted;
  u8* oe_valid;  // [N, D, K]
  int *oe_type, *oe_a, *oe_b, *oe_c;
  u8* oc_valid;  // [N, A]
  int *oc_src, *oc_dest, *oc_due, *oc_mid, *oc_reply_to, *oc_type, *oc_a,
      *oc_b, *oc_c;
};
constexpr int kStepPtrs = sizeof(StepArgs) / sizeof(void*);

struct StepInts {
  int N, D, K, C, A, G, M, session, beat;
};

// int32 arithmetic that wraps, as XLA's
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (int)((unsigned)a << s);
}
// the 16-bit wire field at `shift`, minus 1 (arithmetic >> on int32)
__device__ __forceinline__ int field16(int w, int shift) {
  return ((w >> shift) & 0xFFFF) - 1;
}

__global__ void kafka_kernel(StepArgs A, StepInts I) {
  const int n = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int K = I.K, C = I.C, D = I.D, G = I.G, M = I.M;
  const long long nK = (long long)n * K;
  const int rnd = *A.round;
  const bool stalled = A.stall != nullptr && A.stall[n];

  __shared__ int len_s[MAXK], changed_s[MAXK], rep_at[MAXK];
  __shared__ int cli_key[MAXA], cli_at[MAXA];
  __shared__ int ggen_s[MAXG], gexp_s[MAXG];
  if (t < MAXG) gexp_s[t] = 0;
  __syncthreads();

  // 1. inbound replication: peer lengths, and per key the lowest edge
  // whose offer lands at my length
  for (int i = t; i < D * K; i += T) {
    const long long e = (long long)n * D * K + i;
    const bool rep = A.e_valid[e] && A.e_type[e] == T_REPL;
    A.o_peer_len[e] = rep ? A.e_a[e] : A.peer_len[e];
  }
  if (t < K) {
    const int k = t;
    const int len = A.log_len[nK + k];
    int pick = -1;
    for (int d = 0; d < D && pick < 0; ++d) {
      const long long e = ((long long)n * D + d) * K + k;
      if (A.e_valid[e] && A.e_type[e] == T_REPL) {
        const int b = A.e_b[e];
        if (b == len && b < A.e_a[e] && b < C) pick = d;
      }
    }
    rep_at[k] = -1;
    if (pick >= 0) {
      A.o_log[(nK + k) * C + len] =
          A.e_c[((long long)n * D + pick) * K + k];
      rep_at[k] = len;
    }
    len_s[k] = len + (pick >= 0);
    changed_s[k] = pick >= 0;
  }
  // 2. group maintenance: eviction of silent members (every row)
  if (G) {
    for (int i = t; i < G * M; i += T) {
      const long long j = (long long)n * G * M + i;
      const bool act = A.gactive[j];
      const int seen = A.gseen[j];
      const bool expired = act && wsub(rnd, seen) > I.session;
      A.o_gactive[j] = act && !expired;
      A.o_gseen[j] = seen;
      if (expired) atomicOr(&gexp_s[i / M], 1);
    }
    for (int i = t; i < G * K; i += T) {
      const long long j = (long long)n * G * K + i;
      A.o_gcommitted[j] = A.gcommitted[j];
    }
  }
  __syncthreads();
  if (t < G) ggen_s[t] = wadd(A.ggen[(long long)n * G + t], gexp_s[t]);
  __syncthreads();

  // 3. the client slots, in order, on warp 0
  if (t < 32) {
    const int lane = t;
    int lens[MAXK], cmt[MAXK];
    for (int k = 0; k < K; ++k) {
      lens[k] = len_s[k];
      cmt[k] = A.committed[nK + k];
    }
    int ovf = A.log_overflow[n];
    const bool leader0 = n == 0;
    const int PK = K < MAX_PACK_KEYS ? K : MAX_PACK_KEYS;
    for (int j = 0; j < I.A; ++j) {
      const long long q = (long long)n * I.A + j;
      const bool v = A.c_valid[q];
      const int ty = A.c_type[q], aw = A.c_a[q], bw = A.c_b[q],
                cw = A.c_c[q];
      const int key = mt_clip(aw, 0, K - 1);
      const bool owner = key % I.N == n;
      const bool is_send = v && ty == T_SEND;
      const int off = lens[key];
      const bool full = off >= C;
      const bool do_send = is_send && owner && !full;
      const bool send_full = is_send && owner && full;
      if (do_send) lens[key] = off + 1;
      ovf = wadd(ovf, send_full);
      const bool is_cmt = v && ty == T_COMMIT && leader0;
      const int words[3] = {aw, bw, cw};
      for (int k = 0; k < PK; ++k) {
        const int o = is_cmt ? field16(words[k / 2], 16 * (k % 2)) : -1;
        cmt[k] = cmt[k] > o ? cmt[k] : o;
      }
      const bool is_list = v && ty == T_LIST && leader0;
      const bool is_poll = v && ty == T_POLL;
      const bool misrouted =
          v && ((ty == T_SEND && !owner) ||
                ((ty == T_COMMIT || ty == T_LIST) && !leader0));
      int lw[3] = {0, 0, 0}, pw[3] = {0, 0, 0};
      for (int k = 0; k < PK; ++k) {
        const int sh = 16 * (k % 2);
        lw[k / 2] |= wshl(cmt[k] >= 0 ? wadd(cmt[k], 1) : 0, sh);
        pw[k / 2] |= wshl(wadd(lens[k], 1), sh);
      }
      int rtype = do_send   ? T_SEND_OK
                  : is_cmt  ? T_COMMIT_OK
                  : is_list ? T_LIST_OK
                  : is_poll ? T_POLL_OK
                            : T_ERROR;
      int ra = do_send     ? off
               : is_cmt    ? aw
               : is_list   ? lw[0]
               : is_poll   ? pw[0]
               : send_full ? 14
                           : 11;
      int rb = is_cmt ? bw : is_list ? lw[1] : is_poll ? pw[1] : 0;
      int rc = is_cmt ? cw : is_list ? lw[2] : is_poll ? pw[2] : 0;
      bool say = v && (do_send || is_cmt || is_list || is_poll ||
                       misrouted || send_full);

      // consumer-group RPCs, overlaid on the chain above
      int g_any = 0, m_any = 0, gc[MAXK];
      bool new_act = false, beats = false;
      int ggen_new = 0;
      if (G) {
        const bool is_sub = v && ty == T_SUB && leader0;
        const bool is_fetch = v && ty == T_FETCH;
        const bool is_gcmt = v && ty == T_GCOMMIT && leader0;
        const bool is_glist = v && ty == T_GLIST && leader0;
        const bool g_mis =
            v && (ty == T_SUB || ty == T_GCOMMIT || ty == T_GLIST) &&
            !leader0;
        g_any = mt_clip(is_gcmt    ? (aw >> 26) & 0xF
                        : is_glist ? aw & 0xFFFF
                                   : aw >> 10,
                        0, G - 1);
        const int bank = (is_gcmt || is_glist) ? (aw >> 30) & 1 : 0;
        m_any = mt_clip(is_gcmt ? (aw >> 16) & 0x3FF : aw & 1023, 0, M - 1);
        const int gen16 = aw & 0xFFFF;
        const long long row = ((long long)n * G + g_any) * M;
        const bool old_act = A.o_gactive[row + m_any];
        const int old_gen = ggen_s[g_any];
        const bool fenced =
            is_gcmt && (((old_gen & 0xFFFF) != gen16) || !old_act);
        const bool ok_cmt = is_gcmt && !fenced;
        const bool join = is_sub || fenced;
        const bool newly = join && !old_act;
        new_act = old_act || join;
        beats = is_sub || is_gcmt;
        ggen_new = wadd(old_gen, newly);
        // post-join membership of the row: ballots over the members
        unsigned masks[MAXCH];
        int cnt = 0;
        const int nch = (M + 31) / 32;
        for (int c = 0; c < nch; ++c) {
          const int m = c * 32 + lane;
          const bool bit =
              m < M && (m == m_any ? new_act : A.o_gactive[row + m] != 0);
          masks[c] = __ballot_sync(0xffffffffu, bit);
          cnt += __popc(masks[c]);
        }
        // key k goes to the member of rank k mod count
        int asg[MAXK];
        unsigned ab = 0, ac = 0;
        for (int k = 0; k < K; ++k) {
          asg[k] = -1;
          if (cnt > 0) {
            int r = k % cnt;
            for (int c = 0; c < nch; ++c) {
              const int pc = __popc(masks[c]);
              if (r < pc) {
                unsigned mk = masks[c];
                for (int i = 0; i < r; ++i) mk &= mk - 1;
                asg[k] = c * 32 + __ffs(mk) - 1;
                break;
              }
              r -= pc;
            }
          }
          const unsigned f = asg[k] >= 0 ? (unsigned)(asg[k] + 1) : 0u;
          if (k < 4)
            ab |= f << (8 * k);
          else
            ac |= f << (8 * (k - 4));
        }
        // banked commit: the member's own keys in the bank named
        const long long gcrow = ((long long)n * G + g_any) * K;
        for (int k = 0; k < K; ++k) {
          const int kb = k / BANK_KEYS, kj = k % BANK_KEYS;
          const int o = field16(kj < 2 ? bw : cw, 16 * (kj % 2));
          const bool mine = ok_cmt && asg[k] == m_any && bank == kb;
          const int old = A.o_gcommitted[gcrow + k];
          const int x = mine ? o : -1;
          gc[k] = old > x ? old : x;
        }
        int glb = 0, glc = 0;
        const int base = bank == 1 && K > BANK_KEYS ? BANK_KEYS : 0;
        for (int kj = 0; kj < BANK_KEYS && base + kj < K; ++kj) {
          const int g = gc[base + kj];
          const int f = wshl(g >= 0 ? wadd(g, 1) : 0, 16 * (kj % 2));
          if (kj < 2)
            glb |= f;
          else
            glc |= f;
        }
        // cursor fetch over the reply-round length
        const int fk = mt_clip(bw >> 16, 0, K - 1);
        const int fcur = (bw & 0xFFFF) - 1;
        const int flen = lens[fk];
        int fn = 0;
        if (fcur >= 0) {
          const int have = flen - fcur > 0 ? flen - fcur : 0;
          const int cap = mt_clip(cw, 0, 0x7FFF);
          fn = have < cap ? have : cap;
        }
        rtype = is_fetch   ? T_FETCH_OK
                : is_sub   ? T_SUB_OK
                : fenced   ? T_REBAL
                : ok_cmt   ? T_GCOMMIT_OK
                : is_glist ? T_GLIST_OK
                           : rtype;
        const int gen_banked = (ggen_new & 0x3FFFFFFF) | wshl(bank, 30);
        ra = is_fetch                ? (wshl(fk, 16) | (fcur + 1))
             : (ok_cmt || is_glist)  ? gen_banked
             : (is_sub || fenced)    ? ggen_new
                                     : ra;
        rb = is_fetch               ? fn
             : (is_sub || fenced)   ? (int)ab
             : ok_cmt               ? bw
             : is_glist             ? glb
                                    : rb;
        rc = (is_sub || fenced) ? (int)ac
             : ok_cmt           ? cw
             : is_glist         ? glc
             : is_fetch         ? 0
                                : rc;
        say = say || is_fetch || is_sub || fenced || ok_cmt || is_glist ||
              g_mis;
      }
      __syncwarp();  // every lane has read this slot's state
      if (lane == 0) {
        cli_at[j] = -1;
        if (do_send) {
          A.o_log[(nK + key) * C + off] = bw;
          cli_key[j] = key;
          cli_at[j] = off;
          changed_s[key] = 1;
        }
        if (G) {
          const long long row = ((long long)n * G + g_any) * M;
          A.o_gactive[row + m_any] = new_act;
          if (beats) A.o_gseen[row + m_any] = rnd;
          ggen_s[g_any] = ggen_new;
          const long long gcrow = ((long long)n * G + g_any) * K;
          for (int k = 0; k < K; ++k) A.o_gcommitted[gcrow + k] = gc[k];
        }
        A.oc_valid[q] = say && !stalled;
        A.oc_src[q] = n;
        A.oc_dest[q] = A.c_src[q];
        A.oc_due[q] = A.c_due[q];
        A.oc_mid[q] = A.c_mid[q];
        A.oc_reply_to[q] = A.c_mid[q];
        A.oc_type[q] = rtype;
        A.oc_a[q] = ra;
        A.oc_b[q] = rb;
        A.oc_c[q] = rc;
      }
      __syncwarp();
    }
    if (lane == 0) {
      for (int k = 0; k < K; ++k) {
        len_s[k] = lens[k];
        A.o_log_len[nK + k] = stalled ? A.log_len[nK + k] : lens[k];
        A.o_committed[nK + k] = stalled ? A.committed[nK + k] : cmt[k];
      }
      A.o_log_overflow[n] = stalled ? A.log_overflow[n] : ovf;
    }
  }
  __syncthreads();

  // 4. outbound replication: each neighbour, per key, the entry at the
  // offset it last advertised
  const bool beat = mt_mod(rnd, I.beat) == 0;
  for (int i = t; i < D * K; i += T) {
    const int d = i / K, k = i % K;
    const long long e = (long long)n * D * K + i;
    const int want = A.o_peer_len[e];
    const int have = len_s[k];
    const bool trails = want < have;
    A.oe_valid[e] = (trails || beat || changed_s[k]) &&
                    A.neighbors[(long long)n * D + d] >= 0 && !stalled;
    A.oe_type[e] = T_REPL;
    A.oe_a[e] = have;
    A.oe_b[e] = want;
    A.oe_c[e] = trails ? A.o_log[(nK + k) * C + mt_clip(want, 0, C - 1)] : 0;
  }
  if (!stalled) {
    if (t < G) A.o_ggen[(long long)n * G + t] = ggen_s[t];
    return;
  }
  __syncthreads();  // every lane has read the appended cells

  // a stalled node keeps its old state
  if (t < K && rep_at[t] >= 0) {
    const long long c = (nK + t) * C + rep_at[t];
    A.o_log[c] = A.log[c];
  }
  if (t < I.A && cli_at[t] >= 0) {
    const long long c = (nK + cli_key[t]) * C + cli_at[t];
    A.o_log[c] = A.log[c];
  }
  for (int i = t; i < D * K; i += T) {
    const long long e = (long long)n * D * K + i;
    A.o_peer_len[e] = A.peer_len[e];
  }
  if (G) {
    for (int i = t; i < G * M; i += T) {
      const long long j = (long long)n * G * M + i;
      A.o_gactive[j] = A.gactive[j];
      A.o_gseen[j] = A.gseen[j];
    }
    for (int i = t; i < G * K; i += T) {
      const long long j = (long long)n * G * K + i;
      A.o_gcommitted[j] = A.gcommitted[j];
    }
    if (t < G) A.o_ggen[(long long)n * G + t] = A.ggen[(long long)n * G + t];
  }
}

}  // namespace

// ptrs: the fields of StepArgs in order (the group planes null when G is
//       0, stall null without a stall mask)
// ints: N, D, K (keys = lanes, <= 8), C (log capacity), A (client slots,
//       <= 32), G (groups, <= 16), M (members, <= 256), session_rounds,
//       beat_rounds
MT_API int mt_kafka_step(void* const* p, int n_ptrs, const long long* v,
                         int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kStepPtrs, n_ints, 9))
    return cudaErrorInvalidValue;
  StepArgs A;
  memcpy(&A, p, sizeof(A));
  StepInts I;
  I.N = (int)v[0];
  I.D = (int)v[1];
  I.K = (int)v[2];
  I.C = (int)v[3];
  I.A = (int)v[4];
  I.G = (int)v[5];
  I.M = (int)v[6];
  I.session = (int)v[7];
  I.beat = (int)v[8];
  if (I.N < 1 || I.D < 1 || I.K < 1 || I.K > MAXK || I.C < 1 || I.A < 1 ||
      I.A > MAXA || I.G < 0 || I.G > MAXG || I.beat < 1 ||
      (I.G && (I.M < 1 || I.M > 32 * MAXCH || !A.gactive || !A.o_gactive)))
    return cudaErrorInvalidValue;
  kafka_kernel<<<I.N, 128, 0, (cudaStream_t)stream>>>(A, I);
  return cudaGetLastError();
}
