// K3 broadcast edge_step: one round of the gossip node program.
//
// Replaces maelstrom_tpu/nodes/broadcast.py:BroadcastProgram.edge_step
// (:205) with its helpers _select_gossip (:128), _digest_known (:144),
// _digest_out (:173) and the V <= 64 read-reply packing of
// _pack_seen_words (:338), and the round's freeze of killed and paused
// nodes (maelstrom_tpu/sim.py:_freeze_nodes, :94-112, and the output
// masks at :476-488; mt_broadcast_step_stall). All three modes:
// efficient (send once plus retry), eager resend, and naive (with or
// without skip_sender).
//
// Bound: byte planes, three of them [N, D, V], read and written once a
// round, and a few integer operations a byte: device-memory bytes. At
// 100,000 nodes, D 4, V 1,024 that is 2.77 GB, 0.827 ms at the H100's
// 3.35 TB/s (a torch copy of the same planes takes some 0.87 ms).
//
// The first design (one warp a node, a lane a value, 32 bytes a warp
// load, masks of 7 V bytes a block in shared memory, selection by lane 0)
// took 6.03 ms there: it reread every client row and edge lane once per
// 32 values, kept few loads in flight, scanned masks one word at a time,
// and did not launch past some 33,000 values. This design:
//
// - A row is a run of P lanes of a warp: an edge row (n, d) owns its
//   pending, inflight and inflight_old planes, its owed windows and its
//   out lanes; a node row n owns seen and the client replies. P is the
//   fewest 16-byte lanes that cover V + 15 bytes (a row on any 16-byte
//   offset): 32 / P rows a warp, so small V packs rows (8 at V 32, 4 at
//   V 64). Past 497 values P is 32 and a row is a run of 512-value
//   tiles (loading the next tile ahead of the current one's work spilled
//   registers and lost 7%).
// - The planes move 16 bytes a lane: read as uint4, packed to 16 bits in
//   registers, unpacked on the store. Rows start at n * V and (n * D + d)
//   * V bytes, so lanes sit on the row's 16-byte grid; the partial first
//   and last chunks mask the bytes past the row on the load and store
//   them byte by byte. Planes not 16-byte aligned take the byte path.
// - Sparse inputs are read once a row, a lane an item (the K client rows
//   and D * L edge lanes of the node: the value a broadcast or gossip row
//   carries and its edge), their three fields loaded together. Per tile
//   the items fold by shared-memory atomicOr into three masks (new, that
//   is not in seen; arrived on this edge; arrived on an earlier edge, for
//   naive's first arrival); the owed windows and the 64 seen' bits a
//   digest or a read reply carries are reductions over the same items.
// - The plane loads are issued first, the owed windows are paid and the
//   paid window's seen loads issued before the planes are needed, so a
//   row waits on device memory some three times, not once per step.
// - The rotating selection is a segment-wide prefix sum. The first
//   per_nb pending values in cyclic order from start = (round * per_nb)
//   mod V are those of rank < per_nb among the pending in [start, V),
//   then those of rank < per_nb - P_hi among the pending in [0, start);
//   where fewer than per_nb are pending, jax.lax.top_k fills the other
//   slots with the lowest-index values not pending. Pass 1 computes each
//   tile's pending' and inflight' bits (writing inflight_old', which
//   needs no selection) and counts P_hi; pass 2 scans each lane's three
//   counts (pending below start, at or above it, not pending; packed 10
//   bits each) so every lane knows its values' ranks, and writes the
//   sent values' out lanes and the pending' and inflight' bytes.
// - Pass 2 reads pass 1's bits from a register (tile 0) and shared
//   memory: 128 bytes a tile a warp, 8 warps a block, within 96 KiB up to
//   V = 48,113, the largest V K3 keeps in shared memory. Above it pass 2
//   recomputes them from the input planes (their second read), so shared
//   memory stays 1.5 KiB a block and every V launches. The cache saves
//   8-10% where it applies (1.458 ms against 1.578 recomputed at 100,000
//   nodes, V 1,024).
//
// A stalled node writes its old planes into the fresh ones and no valid
// edge or client row, in the same pass (its out lanes' other fields are
// the unfrozen step's, as freeze_step leaves them). On the cluster axis
// (N = F * nc rows) row n reads neighbors[n % nc] and round[n / nc].
//
// scripts/time_kernels.py --variants times the kernel's parts by building
// this source with MT_K3_PART set (1 without its stores, 2 without its
// plane loads, 3 without its item loads) and MT_K3_CACHE_BUDGET 0 (pass 2
// recomputing pass 1's bits at every V).
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "rows.cuh"

namespace {

constexpr int T_BCAST = 10, T_BCAST_OK = 11, T_READ = 12, T_READ_OK = 13;
constexpr int T_GOSSIP = 14, T_DIGEST = 15;
constexpr int kWarps = 8;                 // rows a block
constexpr int kTile = 512;                // values a tile: 32 lanes x 16
constexpr int kMaskWords = kTile / 32;    // words of a tile mask
constexpr int kMaskArea = 3 * kMaskWords; // new, arrived, arrived before
#ifndef MT_K3_PART
#define MT_K3_PART 0  // the kernel; else a part of it (see the header)
#endif
#ifndef MT_K3_CACHE_BUDGET
#define MT_K3_CACHE_BUDGET (96 * 1024)  // pass 1's bits, a block
#endif
constexpr size_t kCacheBudget = MT_K3_CACHE_BUDGET;

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
  // [N] killed or paused nodes (mt_broadcast_step_stall); null otherwise
  const u8* stall;
};
constexpr int kStepPtrs = sizeof(StepArgs) / sizeof(void*);

struct StepDims {
  int N, D, V, W, L, K, Lout, per_nb, retry, naive, skip_sender, eager;
  // nodes a cluster on the cluster axis (N = F * nc node rows: row n
  // reads neighbors[n % nc] and round[n / nc]); 0 for one cluster, whose
  // round is a scalar
  int nc;
};

// The chunk of values [v0, v0 + 16) of a row: kVec reads the 16-byte
// aligned uint4 (row + v0 is aligned; a chunk wholly outside [0, V) is
// not read); the byte path reads nothing here (bits16 reads its bytes).
template <bool kVec>
__device__ __forceinline__ uint4 raw16(const u8* row, int v0, int V) {
  if (MT_K3_PART == 2 || !kVec || v0 + 16 <= 0 || v0 >= V)
    return make_uint4(0, 0, 0, 0);
  return __ldcs(reinterpret_cast<const uint4*>(row + v0));
}

// --- the items: a node's K client rows, then its D * L edge lanes ----------

// Item i of node n: v the value a broadcast or gossip row carries, clipped
// to [0, V - 1] (-1 for any other row, or past the items), e its edge (-1
// for a client row).
__device__ __forceinline__ void item_at(const StepArgs& A, const StepDims& S,
                                        long long n, int i, int& v, int& e) {
  // the three loads issued together, not each behind the last's test
  v = -1;
  e = -1;
  if (MT_K3_PART == 3) return;
  if (i < S.K) {
    const long long c = n * S.K + i;
    const bool ok = A.c_valid[c] != 0;
    const int t = A.c_type[c], a = A.c_a[c];
    if (ok && t == T_BCAST) v = mt_clip(a, 0, S.V - 1);
  } else if (i < S.K + S.D * S.L) {
    const int j = i - S.K;
    const long long l = n * S.D * S.L + j;
    const bool ok = A.e_valid[l] != 0;
    const int t = A.e_type[l], a = A.e_a[l];
    e = j / S.L;
    if (ok && t == T_GOSSIP) v = mt_clip(a, 0, S.V - 1);
  }
}

struct Items {
  long long n;
  int M;        // K + D * L
  int v0, e0;   // this lane's item among the row's first P
};

// Calls f(v, e) with this lane's item of each run of P items (the first
// run from registers). Every lane of the warp runs every call.
template <class Fn>
__device__ __forceinline__ void each_item(const StepArgs& A,
                                          const StepDims& S, const Seg& g,
                                          const Items& I, Fn f) {
  f(I.v0, I.e0);
  for (int c0 = g.P; c0 < I.M; c0 += g.P) {
    int v, e;
    item_at(A, S, I.n, c0 + g.sl, v, e);
    f(v, e);
  }
}

// Folds the items into the row's masks of the tile of values [tb, tb +
// 16P) (its bits at q = 16 * base + value - tb of the warp's 512): mk[0,
// 16) new (not in seen), mk[16, 32) arrived on edge d, mk[32, 48) arrived
// on an edge before d (when `before`); returns this lane's 16 bits of each.
__device__ __forceinline__ void tile_masks(const StepArgs& A,
                                           const StepDims& S, const Seg& g,
                                           const Items& I, unsigned* mk,
                                           int tb, int d, bool before,
                                           unsigned& nw16, unsigned& ar16,
                                           unsigned& bf16) {
  const int lane = threadIdx.x & 31, tw = 16 * g.P;
  const u8* seen = A.seen + I.n * S.V;
  __syncwarp();  // every lane has read the last tile's masks
  if (lane < kMaskWords) {
    mk[lane] = 0u;
    mk[kMaskWords + lane] = 0u;
    mk[2 * kMaskWords + lane] = 0u;
  }
  __syncwarp();
  each_item(A, S, g, I, [&](int v, int e) {
    const int p = v - tb;
    if (v < 0 || p < 0 || p >= tw) return;
    const int q = 16 * g.base + p;
    const unsigned bit = 1u << (q & 31);
    const int w = q >> 5;
    if (seen[v] == 0) atomicOr(mk + w, bit);
    if (e == d) atomicOr(mk + kMaskWords + w, bit);
    if (before && e >= 0 && e < d) atomicOr(mk + 2 * kMaskWords + w, bit);
  });
  __syncwarp();
  const int w = lane >> 1, sh = (lane & 1) * 16;
  nw16 = (mk[w] >> sh) & 0xFFFFu;
  ar16 = (mk[kMaskWords + w] >> sh) & 0xFFFFu;
  bf16 = (mk[2 * kMaskWords + w] >> sh) & 0xFFFFu;
}

// The seen bits of window w (values 64w .. 64w + 63) this lane reads:
// issued early, their loads overlap what follows.
__device__ __forceinline__ unsigned long long seen_window_load(
    const StepArgs& A, const StepDims& S, const Seg& g, long long n,
    int w) {
  const u8* row = A.seen + n * S.V;
  const long long w64 = (long long)w * 64;
  unsigned long long acc = 0ull;
  for (int j = g.sl; j < 64; j += g.P)
    if (w64 + j < S.V && row[w64 + j]) acc |= 1ull << j;
  return acc;
}

// The 64 seen' bits (seen or arrived) of window w from this lane's seen
// bits `acc`: lo the values 64w .. 64w + 31, hi the next 32.
__device__ __forceinline__ void seen_window(const StepArgs& A,
                                            const StepDims& S, const Seg& g,
                                            const Items& I, int w,
                                            unsigned long long acc,
                                            unsigned& lo, unsigned& hi) {
  const long long w64 = (long long)w * 64;
  each_item(A, S, g, I, [&](int x, int) {
    const long long p = x - w64;
    if (x >= 0 && p >= 0 && p < 64) acc |= 1ull << p;
  });
  lo = seg_or(g, (unsigned)acc);
  hi = seg_or(g, (unsigned)(acc >> 32));
}

// --- the node row: seen' and the client replies ----------------------------

// kTiles: P = 32 and a row of several 512-value tiles; else one tile of
// 16P >= V + 15 values covers the row. `live` false: a lane of a row past
// the last, which runs the warp's collectives and stores nothing.
template <bool kVec, bool kTiles>
__device__ void node_row(const StepArgs& A, const StepDims& S, const Seg& g,
                         unsigned* mk, int n, bool live) {
  const int V = S.V, tw = 16 * g.P;
  const u8* row = A.seen + (long long)n * V;
  u8* orow = A.o_seen + (long long)n * V;
  const int s = kVec ? (int)(reinterpret_cast<uintptr_t>(row) & 15) : 0;
  uint4 q = raw16<kVec>(row, 16 * g.sl - s, V);  // tile 0, in flight
  const bool st = A.stall != nullptr && A.stall[n] != 0;
  Items I;
  I.n = n;
  I.M = S.K + S.D * S.L;
  item_at(A, S, n, g.sl, I.v0, I.e0);
  const int T = kTiles ? (V + s + tw - 1) / tw : 1;
  for (int t = 0; t < T; ++t) {
    const int tb = t * tw - s, v0 = tb + 16 * g.sl;
    if (t > 0) q = raw16<kVec>(row, v0, V);
    unsigned nw, ar, bf;
    tile_masks(A, S, g, I, mk, tb, S.D, false, nw, ar, bf);
    const unsigned sb = bits16<kVec>(q, row, v0, V);
    if (live) store16<kVec>(orow, v0, V, st ? sb : sb | nw);
  }
  unsigned lo = 0u, hi = 0u;
  if (V <= 64)  // rides the read reply
    seen_window(A, S, g, I, 0, seen_window_load(A, S, g, n, 0), lo, hi);
  if (!live) return;
  for (int k = g.sl; k < S.K; k += g.P) {
    const long long i = (long long)n * S.K + k;
    const bool cb = A.c_valid[i] && A.c_type[i] == T_BCAST;
    const bool rd = A.c_valid[i] && A.c_type[i] == T_READ;
    A.oc_valid[i] = (cb || rd) && !st;
    A.oc_src[i] = A.c_src[i];
    A.oc_dest[i] = A.c_src[i];
    A.oc_due[i] = A.c_due[i];
    A.oc_mid[i] = A.c_mid[i];
    A.oc_reply_to[i] = A.c_mid[i];
    A.oc_type[i] = cb ? T_BCAST_OK : (rd ? T_READ_OK : 0);
    A.oc_a[i] = 0;
    if (V <= 64) {
      A.oc_b[i] = rd ? (int)lo : 0;
      A.oc_c[i] = rd ? (int)hi : 0;
    } else {
      A.oc_b[i] = A.c_b[i];
      A.oc_c[i] = A.c_c[i];
    }
  }
}

// --- an edge row: pending, inflight, inflight_old, owed, the out lanes -----

template <bool kVec, bool kTiles>
__device__ void edge_row(const StepArgs& A, const StepDims& S, const Seg& g,
                         unsigned* mk, unsigned* cache, int r, bool live) {
  const int lane = threadIdx.x & 31, V = S.V, L = S.L, tw = 16 * g.P;
  const int n = r / S.D, d = r - n * S.D;
  const long long nd = r, ro = nd * V;
  const bool naive = S.naive != 0;
  const u8 *pr = A.pending + ro, *fr = A.inflight + ro,
           *orr = A.inflight_old + ro;
  u8 *opr = A.o_pending + ro, *ofr = A.o_inflight + ro,
     *oor = A.o_inflight_old + ro;
  const int s = kVec ? (int)(reinterpret_cast<uintptr_t>(pr) & 15) : 0;
  const int T = kTiles ? (V + s + tw - 1) / tw : 1;

  // the planes of a tile: issued first, so their loads overlap the rest
  uint4 qp, qf = make_uint4(0, 0, 0, 0), qo = qf;
  auto load = [&](int t, uint4& p_, uint4& f_, uint4& o_) {
    const int v0 = t * tw - s + 16 * g.sl;
    p_ = raw16<kVec>(pr, v0, V);
    if (!naive) {
      f_ = raw16<kVec>(fr, v0, V);
      o_ = raw16<kVec>(orr, v0, V);
    }
  };
  load(0, qp, qf, qo);
  // and the first owed windows
  const long long wo = nd * S.W;
  const bool o0_first = !naive && g.sl < S.W && A.owed[wo + g.sl] != 0;

  const bool st = A.stall != nullptr && A.stall[n] != 0;
  const long long local = S.nc > 0 ? n % S.nc : n;  // the table's row
  const bool eok = A.neighbors[local * S.D + d] >= 0;
  const int round = S.nc > 0 ? A.round[n / S.nc] : *A.round;
  const bool requeue = mt_mod(round, S.retry) == 0;
  const int start = (int)(((long long)round * S.per_nb % V + V) % V);
  Items I;
  I.n = n;
  I.M = S.K + S.D * S.L;
  item_at(A, S, n, g.sl, I.v0, I.e0);

  // the last digest lane of the edge wins
  bool has_dig = false;
  int w_in = 0, b_in = 0, c_in = 0;
  if (!naive) {
    for (int l0 = 0; l0 < L; l0 += g.P) {
      const long long e = nd * L + l0 + g.sl;
      const bool dg =
          l0 + g.sl < L && A.e_valid[e] && A.e_type[e] == T_DIGEST;
      int a = 0, b = 0, c = 0;
      if (dg) {
        a = A.e_a[e];
        b = A.e_b[e];
        c = A.e_c[e];
      }
      const unsigned m = seg_ballot(g, dg);
      const int src = m ? 31 - __clz(m) : 0;
      a = seg_get(g, a, src);
      b = seg_get(g, b, src);
      c = seg_get(g, c, src);
      if (m) {
        has_dig = true;
        w_in = a;
        b_in = b;
        c_in = c;
      }
    }
  }
  const unsigned long long dig =
      (unsigned long long)(unsigned)c_in << 32 | (unsigned)b_in;
  const unsigned dbase = (unsigned)w_in * 64u;

  // owe the windows gossip arrived in; pay the lowest owed one (before
  // the planes, so the paid window's seen loads overlap them)
  int w_send = -1;
  if (!naive) {
    for (int w0 = 0; w0 < S.W; w0 += g.P) {
      const int w = w0 + g.sl;
      const bool o0 =
          w0 == 0 ? o0_first : w < S.W && A.owed[wo + w] != 0;
      unsigned am = 0u;
      each_item(A, S, g, I, [&](int v, int e) {
        const int win = v >> 6;
        if (v >= 0 && e == d && win >= w0 && win < w0 + g.P)
          am |= 1u << (win - w0);
      });
      am = seg_or(g, am);
      const bool o = w < S.W && (o0 || ((am >> g.sl) & 1u));
      const unsigned ballot = seg_ballot(g, o);
      if (ballot && w_send < 0) w_send = w0 + __ffs(ballot) - 1;
      if (live && w < S.W) A.o_owed[wo + w] = st ? o0 : o && w != w_send;
    }
  }
  const bool have = w_send >= 0;
  const int ws = have ? w_send : 0;
  const unsigned long long dacc =
      naive ? 0ull : seen_window_load(A, S, g, n, ws);

  // tile t's pending' bits (low 16) and inflight' bits (high 16) from its
  // planes; `store` (pass 1) writes inflight_old' and a stalled row's
  // planes
  auto bits = [&](int t, uint4 p_, uint4 f_, uint4 o_, bool store) {
    const int tb = t * tw - s, v0 = tb + 16 * g.sl;
    unsigned nw, ar, bf;
    tile_masks(A, S, g, I, mk, tb, d, naive && S.skip_sender, nw, ar, bf);
    const unsigned P = bits16<kVec>(p_, pr, v0, V);
    const unsigned add = eok ? nw : 0u;
    store = store && live;
    if (naive) {
      const unsigned known = S.skip_sender ? ar & ~bf : 0u;
      if (store && st) store16<kVec>(opr, v0, V, P);
      return (P | add) & ~known;
    }
    const unsigned F = bits16<kVec>(f_, fr, v0, V);
    const unsigned O = bits16<kVec>(o_, orr, v0, V);
    const unsigned known = ar | digest16(has_dig, dig, dbase, v0);
    if (store) {
      store16<kVec>(oor, v0, V, st ? O : (requeue ? F : O) & ~known);
      if (st) {
        store16<kVec>(opr, v0, V, P);
        store16<kVec>(ofr, v0, V, F);
      }
    }
    const unsigned pend = (P | add | (requeue ? O : 0u)) & ~known;
    const unsigned i2 = requeue ? 0u : F & ~known;
    return (pend & 0xFFFFu) | i2 << 16;
  };

  // pass 1: the bits (tile 0's kept in a register, the others in shared
  // memory or recomputed), inflight_old', and the pending counts
  unsigned b0 = 0u;
  int hi_cnt = 0, all_cnt = 0;
  for (int t = 0; t < T; ++t) {
    if (t > 0) load(t, qp, qf, qo);
    const unsigned b = bits(t, qp, qf, qo, true);
    if (t == 0)
      b0 = b;
    else if (cache)
      cache[t * 32 + lane] = b;
    const unsigned pend = b & 0xFFFFu;
    hi_cnt += __popc(pend & ~below16(t * tw - s + 16 * g.sl, start));
    all_cnt += __popc(pend);
  }
  const int p_hi = seg_add(g, hi_cnt);
  const int p_all = seg_add(g, all_cnt);

  // pass 2: ranks, the sent values, their out lanes, pending', inflight'
  const int per_nb = S.per_nb;
  const int take_lo = p_hi < per_nb ? per_nb - p_hi : 0;  // from [0, start)
  const int n_sel = p_all < per_nb ? p_all : per_nb;
  const int n_fill = per_nb - n_sel;  // lowest values not pending
  const long long ob = nd * S.Lout + (naive ? 0 : 1);  // first gossip lane
  const u8 ev = eok && !st;
  int run_lo = 0, run_hi = 0, run_np = 0;
  for (int t = 0; t < T; ++t) {
    unsigned b = b0;
    if (t > 0 && cache) {
      b = cache[t * 32 + lane];
    } else if (t > 0) {
      load(t, qp, qf, qo);
      b = bits(t, qp, qf, qo, false);
    }
    const unsigned pend = b & 0xFFFFu, i2 = b >> 16;
    const int v0 = t * tw - s + 16 * g.sl;
    const unsigned below = below16(v0, start);
    const unsigned lo = pend & below, hi = pend & ~below;
    const unsigned np = range16(v0, V) & ~pend;
    // three counts of at most 512 a tile, 10 bits each, in one scan
    const unsigned mine = __popc(lo) | __popc(hi) << 10 | __popc(np) << 20;
    const unsigned incl = seg_scan(g, mine);
    const unsigned excl = incl - mine;
    const unsigned tot = (unsigned)seg_get(g, (int)incl, g.P - 1);
    int r_hi = run_hi + (int)((excl >> 10) & 1023u);
    int r_lo = run_lo + (int)(excl & 1023u);
    int r_np = run_np + (int)(excl >> 20);
    run_lo += (int)(tot & 1023u);
    run_hi += (int)((tot >> 10) & 1023u);
    run_np += (int)(tot >> 20);
    if (!live) continue;
    unsigned sent = 0u;
    for (unsigned m = hi; m && r_hi < per_nb; m &= m - 1, ++r_hi) {
      const int k = __ffs(m) - 1;
      sent |= 1u << k;
      A.oe_valid[ob + r_hi] = ev;
      A.oe_a[ob + r_hi] = v0 + k;
    }
    for (unsigned m = lo; m && r_lo < take_lo; m &= m - 1, ++r_lo) {
      const int k = __ffs(m) - 1;
      sent |= 1u << k;
      A.oe_valid[ob + p_hi + r_lo] = ev;
      A.oe_a[ob + p_hi + r_lo] = v0 + k;
    }
    for (unsigned m = np; m && r_np < n_fill; m &= m - 1, ++r_np) {
      A.oe_valid[ob + n_sel + r_np] = 0;
      A.oe_a[ob + n_sel + r_np] = v0 + __ffs(m) - 1;
    }
    if (st) continue;  // pass 1 wrote a stalled row's planes
    if (naive) {
      store16<kVec>(opr, v0, V, pend & ~sent);
    } else if (S.eager) {
      store16<kVec>(opr, v0, V, pend);
      store16<kVec>(ofr, v0, V, i2);
    } else {
      store16<kVec>(opr, v0, V, pend & ~sent);
      store16<kVec>(ofr, v0, V, i2 | sent);
    }
  }
  if (live) {
    for (int j = g.sl; j < per_nb; j += g.P) {
      A.oe_type[ob + j] = T_GOSSIP;
      A.oe_b[ob + j] = 0;
      A.oe_c[ob + j] = 0;
    }
  }
  // the digest lane: the seen' bits of the window paid
  unsigned lo = 0u, hi = 0u;
  if (!naive) seen_window(A, S, g, I, ws, dacc, lo, hi);

  if (naive || !live || g.sl != 0) return;
  const long long o = nd * S.Lout;
  A.oe_valid[o] = have && eok && !st;
  A.oe_type[o] = T_DIGEST;
  A.oe_a[o] = ws;
  A.oe_b[o] = (int)lo;
  A.oe_c[o] = (int)hi;
}

// Warp g of the grid: below edge_warps, 32 / P edge rows n * D + d (P
// lanes each), then 32 / P node rows n. A warp's shared memory: the three
// tile masks, then `cache_words` words of pass 1's bits (kTiles only; 0:
// pass 2 recomputes them).
template <bool kVec, bool kTiles>
__global__ void __launch_bounds__(kWarps * 32, 4)
    step_kernel(StepArgs A, StepDims S, int P, int edge_warps,
                int node_warps, int cache_words) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + warp;
  if (gw >= edge_warps + node_warps) return;  // whole warps leave
  const Seg g = make_seg(kTiles ? 32 : P);
  const int seg = lane / g.P, rows = 32 / g.P;
  unsigned* mk = smem + warp * (kMaskArea + cache_words);
  if (gw < edge_warps) {
    const int ND = S.N * S.D, r = gw * rows + seg;
    const bool live = r < ND && (MT_K3_PART != 1 || S.N < 0);
    edge_row<kVec, kTiles>(A, S, g, mk,
                           cache_words ? mk + kMaskArea : nullptr,
                           live ? r : ND - 1, live);
  } else {
    const int n = (gw - edge_warps) * rows + seg;
    const bool live = n < S.N && (MT_K3_PART != 1 || S.N < 0);
    node_row<kVec, kTiles>(A, S, g, mk, live ? n : S.N - 1, live);
  }
}

}  // namespace

namespace {

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kTiles>
cudaError_t launch(const StepArgs& args, const StepDims& dims, bool vec,
                   int P, int edge_warps, int node_warps, int cache_words,
                   cudaStream_t stream) {
  void (*kern)(StepArgs, StepDims, int, int, int, int) =
      vec ? &step_kernel<true, kTiles> : &step_kernel<false, kTiles>;
  const size_t smem =
      (size_t)kWarps * (kMaskArea + cache_words) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<mt_blocks((long long)edge_warps + node_warps, kWarps),
         kWarps * 32, smem, stream>>>(args, dims, P, edge_warps, node_warps,
                                      cache_words);
  return cudaGetLastError();
}

int launch_step(void* const* p, int n_ptrs, const long long* v, int n_ints,
                void* stream, bool with_stall) {
  if (mt_bad_args(n_ptrs, kStepPtrs - (with_stall ? 0 : 1), n_ints, 13) ||
      v[12] < 0 || (v[12] > 0 && v[0] % v[12]))
    return cudaErrorInvalidValue;
  StepArgs args;
  memcpy(&args, p, sizeof(void*) * n_ptrs);
  if (!with_stall)
    args.stall = nullptr;
  else if (args.stall == nullptr)
    return cudaErrorInvalidValue;
  StepDims dims = {(int)v[0], (int)v[1], (int)v[2],  (int)v[3],
                   (int)v[4], (int)v[5], (int)v[6],  (int)v[7],
                   (int)v[8], (int)v[9], (int)v[10], (int)v[11],
                   (int)v[12]};
  if (dims.N == 0) return cudaSuccess;
  // rows and tile offsets in int
  if ((long long)dims.N * (dims.D + 1) > 0x7fffffffLL - 32 * kWarps ||
      dims.V < 1 || dims.V > 0x7fffffff - 2 * kTile)
    return cudaErrorInvalidValue;
  // P lanes a row: the fewest 16-byte lanes that cover V + 15 bytes (a
  // row on any 16-byte offset), up to 32; past that 32 and 512-value
  // tiles
  int P = 1;
  while (P < 32 && 16 * P < dims.V + 15) P *= 2;
  const bool tiles = 16 * P < dims.V + 15;
  const int rows = 32 / P;
  const int edge_warps = (int)(((long long)dims.N * dims.D + rows - 1) / rows);
  const int node_warps = (dims.N + rows - 1) / rows;
  // pass 1's bits in shared memory when 8 warps' fit the budget
  const long long n_tiles = ((long long)dims.V + 15 + kTile - 1) / kTile;
  int cache_words = 0;
  if (tiles && (size_t)kWarps * (kMaskArea + 32 * n_tiles) *
                       sizeof(unsigned) <= kCacheBudget)
    cache_words = (int)(32 * n_tiles);
  const bool vec = aligned16(args.seen) && aligned16(args.pending) &&
                   aligned16(args.inflight) &&
                   aligned16(args.inflight_old) && aligned16(args.o_seen) &&
                   aligned16(args.o_pending) && aligned16(args.o_inflight) &&
                   aligned16(args.o_inflight_old);
  const cudaStream_t st = (cudaStream_t)stream;
  return tiles ? launch<true>(args, dims, vec, P, edge_warps, node_warps,
                              cache_words, st)
               : launch<false>(args, dims, vec, P, edge_warps, node_warps,
                               0, st);
}

}  // namespace

// ptrs: the fields of StepArgs in order but the last (stall); ints: the
// fields of StepDims (nc last: 0 for one cluster and a scalar round, else
// the nodes a cluster of the F * nc rows, neighbors the [nc, D] table of
// one cluster and round an [F] array)
MT_API int mt_broadcast_step(void* const* p, int n_ptrs, const long long* v,
                             int n_ints, void* stream) {
  return launch_step(p, n_ptrs, v, n_ints, stream, false);
}

// K3 with the stall mask (enable_stall): ptrs: every field of StepArgs,
// the [N] stall mask last
MT_API int mt_broadcast_step_stall(void* const* p, int n_ptrs,
                                   const long long* v, int n_ints,
                                   void* stream) {
  return launch_step(p, n_ptrs, v, n_ints, stream, true);
}
