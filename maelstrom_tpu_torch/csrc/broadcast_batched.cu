// K15 batched-broadcast edge_step: one round of the batched atomic
// broadcast node program.
//
// Replaces maelstrom_tpu/nodes/broadcast_batched.py:
// BroadcastBatchedProgram.edge_step (:140) with _select_ranges (:115),
// and the parent protocol it reuses (_digest_known, _digest_out of
// maelstrom_tpu/nodes/broadcast.py:144, :173): range-gossip arrivals
// expanded into seen, client batches expanded with their count and
// checksum proof, digest receive and send, the retry ticks, and up to
// per_nb maximal runs of pending ids per edge; and the round's freeze of
// killed and paused nodes (maelstrom_tpu/sim.py:94-112, the output masks
// at :476-488; mt_broadcast_batched_step_stall).
//
// Bound: five byte planes, three of them [N, D, V], read and written once
// a round, and a few integer operations a byte: device-memory bytes. At
// 100,000 nodes, D 4, V 1,024 that is 2.744 GB, 0.819 ms at the H100's
// 3.35 TB/s.
//
// The first design (one warp a node, a lane a value) took 5.21 ms there.
// It reread the node's K client rows and D * L edge lanes once per 32
// values, moved one byte a lane, walked a node's edges and chunks in
// order with few loads in flight, extracted the runs by lane 0 alone, and
// kept six V-bit masks a warp in shared memory, in global scratch past
// some 270,000 values. This design takes K3's (csrc/broadcast.cu) rows:
//
// - A row is a run of P lanes of a warp: an edge row (n, d) owns its
//   pending, inflight and inflight_old planes, its owed windows and its
//   out lanes; a node row n owns seen and the client replies. P is the
//   fewest 16-byte lanes that cover V + 15 bytes (a row on any 16-byte
//   offset), so small V packs 32 / P rows into a warp; past 497 values
//   P is 32 and a row is a run of 512-value tiles. The planes move 16
//   bytes a lane (rows.cuh), loaded at the start of each tile.
// - The node's items, its K client rows and D * L edge lanes, are read
//   once a row, a lane an item, their fields loaded together, as clipped
//   intervals [lo, hi) (a T_BATCH batch, a T_GRANGE run) with their edge.
//   Per tile they fold into two 512-bit masks a warp in shared memory by
//   atomicOr over the words an interval covers: any item (new values,
//   seen') and this edge's arrivals (known); a tile no item touches skips
//   the fold. An edge row reads seen's chunk only where an item lands,
//   from the one or two aligned words that hold it.
// - The owed windows come from the same intervals (an interval owes
//   windows lo >> 6 to (hi - 1) >> 6); the lowest owed one is paid before
//   the tiles, and the 64 seen' bits of the paid window are seen's four
//   chunks there (loaded then, consumed at the end) and the intervals.
// - The runs are selected in the tile pass. The first per_nb maximal
//   runs of pending' are those whose end (the first value past the run)
//   ranks below per_nb among the run ends, and the values sent are the
//   pending ones below the per_nb-th end, the cut. Per tile each lane
//   finds its run starts and ends from its 16 bits and its left
//   neighbour's top bit, ranks its ends by a segment prefix sum, and pairs
//   each end with the last start before it (in its bits, else by a
//   segment prefix maximum, else the run still open from an earlier
//   tile). The lane holding a ranked end writes that out lane; the tile's
//   stores only test the rank, so no second pass and no bit cache. The
//   open run, its start and the count of ends carry across tiles; a run
//   open at V ends there. Lanes past the last run get lo 0, n 0, valid
//   false, as JAX's argmax of all-false gives.
// - Shared memory is 128 bytes a warp at every V, so every V launches on
//   the one path.
//
// On the card (NVIDIA H100 80GB HBM3, 700 W): 1.229 ms at 100,000 nodes
// (1.41 times a torch copy of its planes' bytes), 0.034 ms at the
// bench's 4,096 nodes, V 512 (bound 0.017), where each row's chain of
// dependent reads (items, owed, the paid window's seen, seen's chunk)
// sets the time (PERF.md section 6, scripts/time_kernels.py).
//
// The proof: the expanded range is [lo, min(lo + n, V)) with lo and n
// clipped to [0, V]. Its count is exact; its checksum is JAX's int32 sum
// of the ids, which wraps once the ids pass 65,536, then the floor mod by
// 2^31 - 1. The sum is taken in 64 bits and truncated to 32, which is the
// wrapped int32 sum.
//
// A stalled node writes its old planes into the fresh ones and no valid
// edge or client row in the same pass (its out lanes' other fields are
// the unfrozen step's, as freeze_step leaves them).
//
// The launch plan (P, the edge and node warps) is computed by the
// wrapper (nodes/broadcast_batched.py batched_plan) and checked here.
// scripts/time_kernels.py --variants times the kernel's parts by building
// this source with MT_K15_PART set: 1 without its stores, 2 without its
// plane loads, 3 without its item loads.
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "rows.cuh"

namespace {

constexpr int T_DIGEST = 15;
constexpr int T_BATCH = 20, T_BATCH_OK = 21, T_BREAD = 22, T_BREAD_OK = 23;
constexpr int T_GRANGE = 24;
constexpr int PROOF_MOD = 0x7FFFFFFF;
constexpr int kWarps = 8;                  // warps a block
constexpr int kTile = 512;                 // values a tile: 32 lanes x 16
constexpr int kMaskWords = kTile / 32;     // words of a tile mask
constexpr int kMaskArea = 2 * kMaskWords;  // any item, this edge's arrivals
static_assert(kMaskArea == 32, "a lane clears one mask word");
#ifndef MT_K15_PART
#define MT_K15_PART 0  // the kernel; else a part of it (see the header)
#endif

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
  // [N] killed or paused nodes (the stall entry point); null otherwise
  const u8* stall;
};
constexpr int kStepPtrs = sizeof(StepArgs) / sizeof(void*);

struct StepDims {
  int N, D, V, W, L, K, Lout, per_nb, retry, eager;
};

// The chunk of values [v0, v0 + 16) of a row: kVec reads the 16-byte
// aligned uint4 (row + v0 is aligned; a chunk wholly outside [0, V) is
// not read); the byte path reads nothing here (bits16 reads its bytes).
template <bool kVec>
__device__ __forceinline__ uint4 raw16(const u8* row, int v0, int V) {
  if (MT_K15_PART == 2 || !kVec || v0 + 16 <= 0 || v0 >= V)
    return make_uint4(0, 0, 0, 0);
  return __ldcs(reinterpret_cast<const uint4*>(row + v0));
}

// --- the items: a node's K client rows, then its D * L edge lanes ----------

// Item i of node n: the interval [lo, hi) of values a T_BATCH client row
// or a T_GRANGE edge lane carries, clipped to [0, V) (lo == hi for any
// other row, or past the items), and e its edge (-1 for a client row).
__device__ __forceinline__ void item_at(const StepArgs& A, const StepDims& S,
                                        long long n, int i, int& lo,
                                        int& hi, int& e) {
  lo = hi = 0;
  e = -1;
  if (MT_K15_PART == 3 || i >= S.K + S.D * S.L) return;
  // the four loads issued together, not each behind the last's test
  bool ok;
  int t, a, b, want;
  if (i < S.K) {
    const long long c = n * S.K + i;
    ok = A.c_valid[c] != 0;
    t = A.c_type[c];
    a = A.c_a[c];
    b = A.c_b[c];
    want = T_BATCH;
  } else {
    const int j = i - S.K;
    const long long l = n * S.D * S.L + j;
    ok = A.e_valid[l] != 0;
    t = A.e_type[l];
    a = A.e_a[l];
    b = A.e_b[l];
    e = j / S.L;
    want = T_GRANGE;
  }
  if (ok && t == want) {
    lo = mt_clip(a, 0, S.V);
    hi = lo + min(mt_clip(b, 0, S.V), S.V - lo);
  }
}

struct Items {
  long long n;
  int M;             // K + D * L
  int lo0, hi0, e0;  // this lane's item among the row's first P
};

// Calls f(lo, hi, e) with this lane's item of each run of P items (the
// first run from registers). Every lane of the warp runs every call.
template <class Fn>
__device__ __forceinline__ void each_item(const StepArgs& A,
                                          const StepDims& S, const Seg& g,
                                          const Items& I, Fn f) {
  f(I.lo0, I.hi0, I.e0);
  for (int c0 = g.P; c0 < I.M; c0 += g.P) {
    int lo, hi, e;
    item_at(A, S, I.n, c0 + g.sl, lo, hi, e);
    f(lo, hi, e);
  }
}

// Folds the items into the warp's masks of the tile of values [tb, tb +
// 16P) (a row's bits at q = 16 * base + value - tb of the warp's 512):
// mk[0, 16) any item, mk[16, 32) the items of edge d (none for d < 0).
// Returns this lane's 16 bits of each. The masks are zero on entry and on
// return.
__device__ __forceinline__ void tile_masks(const StepArgs& A,
                                           const StepDims& S, const Seg& g,
                                           const Items& I, unsigned* mk,
                                           int tb, int d, unsigned& any16,
                                           unsigned& arr16) {
  const int lane = threadIdx.x & 31, tw = 16 * g.P;
  bool hit = false;
  each_item(A, S, g, I, [&](int lo, int hi, int e) {
    const int a = max(lo, tb), b = min(hi, tb + tw);
    if (a >= b) return;
    hit = true;
    const int q0 = 16 * g.base + a - tb, q1 = 16 * g.base + b - tb;
    const bool mine = e >= 0 && e == d;
    for (int w = q0 >> 5; w <= (q1 - 1) >> 5; ++w) {
      const int x0 = max(q0 - 32 * w, 0), x1 = min(q1 - 32 * w, 32);
      const unsigned bits =
          x1 - x0 == 32 ? kFull : ((1u << (x1 - x0)) - 1u) << x0;
      atomicOr(mk + w, bits);
      if (mine) atomicOr(mk + kMaskWords + w, bits);
    }
  });
  any16 = arr16 = 0u;
  if (!__any_sync(kFull, hit)) return;  // nothing folded, masks still 0
  __syncwarp();
  const int w = lane >> 1, sh = (lane & 1) * 16;
  any16 = (mk[w] >> sh) & 0xFFFFu;
  arr16 = (mk[kMaskWords + w] >> sh) & 0xFFFFu;
  __syncwarp();
  mk[lane] = 0u;
  __syncwarp();
}

// The seen bits of window w (values 64w .. 64w + 63) of node n's row, this
// lane's chunks of the four: issued early, their loads overlap what
// follows.
__device__ __forceinline__ unsigned long long seen_window_load(
    const StepArgs& A, const StepDims& S, const Seg& g, long long n,
    int w) {
  const u8* row = A.seen + n * S.V;
  unsigned long long acc = 0ull;
  for (int c = g.sl; c < 4; c += g.P)
    acc |= (unsigned long long)bits16_at(row, 64 * w + 16 * c, S.V)
           << (16 * c);
  return acc;
}

// The 64 seen' bits (seen or any item) of window w from this lane's seen
// bits `acc`: lo the values 64w .. 64w + 31, hi the next 32.
__device__ __forceinline__ void seen_window(const StepArgs& A,
                                            const StepDims& S, const Seg& g,
                                            const Items& I, int w,
                                            unsigned long long acc,
                                            unsigned& lo, unsigned& hi) {
  const long long w64 = (long long)w * 64;
  each_item(A, S, g, I, [&](int a, int b, int) {
    const long long x0 = max((long long)a, w64) - w64;
    const long long x1 = min((long long)b, w64 + 64) - w64;
    if (x0 >= x1) return;
    const unsigned long long top = x1 == 64 ? ~0ull : (1ull << x1) - 1ull;
    acc |= top & ~((1ull << x0) - 1ull);
  });
  lo = seg_or(g, (unsigned)acc);
  hi = seg_or(g, (unsigned)(acc >> 32));
}

__device__ __forceinline__ Items row_items(const StepArgs& A,
                                           const StepDims& S, const Seg& g,
                                           long long n) {
  Items I;
  I.n = n;
  I.M = S.K + S.D * S.L;
  item_at(A, S, n, g.sl, I.lo0, I.hi0, I.e0);
  return I;
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
  const Items I = row_items(A, S, g, n);
  const int T = kTiles ? (V + s + tw - 1) / tw : 1;
  for (int t = 0; t < T; ++t) {
    const int tb = t * tw - s, v0 = tb + 16 * g.sl;
    if (t > 0) q = raw16<kVec>(row, v0, V);
    unsigned any, arr;
    tile_masks(A, S, g, I, mk, tb, -1, any, arr);
    const unsigned sb = bits16<kVec>(q, row, v0, V);
    if (live) store16<kVec>(orow, v0, V, st ? sb : sb | any);
  }
  if (!live) return;
  // client replies: batch acks carry the expansion proof
  for (int k = g.sl; k < S.K; k += g.P) {
    const long long i = (long long)n * S.K + k;
    const bool isb = A.c_valid[i] && A.c_type[i] == T_BATCH;
    const bool rd = A.c_valid[i] && A.c_type[i] == T_BREAD;
    const int lo = mt_clip(A.c_a[i], 0, V);
    const int hi = lo + min(mt_clip(A.c_b[i], 0, V), V - lo);
    const long long cnt = hi - lo;
    // the ids' sum, truncated to 32 bits: JAX's wrapping int32 sum
    const unsigned long long sum =
        (unsigned long long)(cnt * lo + cnt * (cnt - 1) / 2);
    const int proof = mt_mod((int)(unsigned)sum, PROOF_MOD);
    A.oc_valid[i] = (isb || rd) && !st;
    A.oc_src[i] = A.c_src[i];
    A.oc_dest[i] = A.c_src[i];
    A.oc_due[i] = A.c_due[i];
    A.oc_mid[i] = A.c_mid[i];
    A.oc_reply_to[i] = A.c_mid[i];
    A.oc_type[i] = isb ? T_BATCH_OK : (rd ? T_BREAD_OK : 0);
    A.oc_a[i] = isb ? A.c_a[i] : 0;
    A.oc_b[i] = isb ? (int)cnt : 0;
    A.oc_c[i] = isb ? proof : 0;
  }
}

// --- an edge row: pending, inflight, inflight_old, owed, the out lanes -----

template <bool kVec, bool kTiles>
__device__ void edge_row(const StepArgs& A, const StepDims& S, const Seg& g,
                         unsigned* mk, int r, bool live) {
  const int V = S.V, L = S.L, tw = 16 * g.P;
  const int n = r / S.D, d = r - n * S.D;
  const long long nd = r, ro = nd * V;
  const u8 *pr = A.pending + ro, *fr = A.inflight + ro,
           *orr = A.inflight_old + ro, *sr = A.seen + (long long)n * V;
  u8 *opr = A.o_pending + ro, *ofr = A.o_inflight + ro,
     *oor = A.o_inflight_old + ro;
  const int s = kVec ? (int)(reinterpret_cast<uintptr_t>(pr) & 15) : 0;
  const int T = kTiles ? (V + s + tw - 1) / tw : 1;

  // the planes of a tile: issued first, so their loads overlap the rest
  uint4 qp, qf, qo;
  auto load = [&](int t) {
    const int v0 = t * tw - s + 16 * g.sl;
    qp = raw16<kVec>(pr, v0, V);
    qf = raw16<kVec>(fr, v0, V);
    qo = raw16<kVec>(orr, v0, V);
  };
  load(0);
  const long long wo = nd * S.W;
  const bool o0_first = g.sl < S.W && A.owed[wo + g.sl] != 0;

  const bool st = A.stall != nullptr && A.stall[n] != 0;
  const bool eok = A.neighbors[nd] >= 0;
  const bool requeue = mt_mod(*A.round, S.retry) == 0;
  const Items I = row_items(A, S, g, n);

  // the last digest lane of the edge wins
  bool has_dig = false;
  int w_in = 0, b_in = 0, c_in = 0;
  for (int l0 = 0; l0 < L; l0 += g.P) {
    const long long e = nd * L + l0 + g.sl;
    const bool dg = l0 + g.sl < L && A.e_valid[e] && A.e_type[e] == T_DIGEST;
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
  const unsigned long long dig =
      (unsigned long long)(unsigned)c_in << 32 | (unsigned)b_in;
  const unsigned dbase = (unsigned)w_in * 64u;

  // owe the windows ranges arrived in; pay the lowest owed one (before
  // the tiles, so the paid window's seen loads overlap them)
  int w_send = -1;
  for (int w0 = 0; w0 < S.W; w0 += g.P) {
    const int w = w0 + g.sl;
    const bool o0 = w0 == 0 ? o0_first : w < S.W && A.owed[wo + w] != 0;
    unsigned am = 0u;
    each_item(A, S, g, I, [&](int lo, int hi, int e) {
      if (lo >= hi || e != d) return;
      const int a = max(lo >> 6, w0) - w0;
      const int b = min((hi - 1) >> 6, w0 + g.P - 1) - w0;  // inclusive
      if (a > b) return;
      const unsigned top = b == 31 ? kFull : (2u << b) - 1u;
      am |= top & ~((1u << a) - 1u);
    });
    am = seg_or(g, am);
    const bool o = w < S.W && (o0 || ((am >> g.sl) & 1u));
    const unsigned ballot = seg_ballot(g, o);
    if (ballot && w_send < 0) w_send = w0 + __ffs(ballot) - 1;
    if (live && w < S.W) A.o_owed[wo + w] = st ? o0 : o && w != w_send;
  }
  const bool have = w_send >= 0;
  const int ws = have ? w_send : 0;
  const unsigned long long dacc = seen_window_load(A, S, g, n, ws);

  // the tiles: pending', inflight', inflight_old', and the runs
  const int per_nb = S.per_nb;
  const long long ob = nd * S.Lout + 1;  // the first range lane
  const u8 ev = eok && !st;
  unsigned carry = 0u;  // pending' of the value before the tile
  int open_lo = 0;      // where the run open at the tile's start began
  int runs = 0;         // run ends before the tile
  for (int t = 0; t < T; ++t) {
    const int tb = t * tw - s, v0 = tb + 16 * g.sl;
    if (t > 0) load(t);
    unsigned any, arr;
    tile_masks(A, S, g, I, mk, tb, d, any, arr);
    const unsigned rng = range16(v0, V);
    const unsigned Pb = bits16<kVec>(qp, pr, v0, V);
    const unsigned Fb = bits16<kVec>(qf, fr, v0, V);
    const unsigned Ob = bits16<kVec>(qo, orr, v0, V);
    const unsigned nw = eok && (any & rng) ? any & ~bits16_at(sr, v0, V)
                                           : 0u;
    const unsigned known = arr | digest16(has_dig, dig, dbase, v0);
    const unsigned pend = (Pb | nw | (requeue ? Ob : 0u)) & ~known & rng;
    const unsigned i2 = requeue ? 0u : Fb & ~known;

    // run starts and ends: an end is the first value past a run, V too
    const unsigned up = __shfl_up_sync(kFull, pend, 1);
    const unsigned pin = g.sl ? (up >> 15) & 1u : carry;
    const unsigned prev = ((pend << 1) | pin) & 0xFFFFu;
    const unsigned starts = pend & ~prev;
    const unsigned ends = ~pend & prev & range16(v0, V + 1);
    const int ecnt = __popc(ends);
    const int eincl = (int)seg_scan(g, (unsigned)ecnt);
    const int rank0 = runs + eincl - ecnt;
    const int last = starts ? v0 + 31 - __clz(starts) : -1;
    const int sincl = seg_max_scan(g, last);
    int before = __shfl_up_sync(kFull, sincl, 1);
    if (g.sl == 0 || before < 0) before = open_lo;
    unsigned sent = 0u;
    if (rank0 < per_nb) {
      sent = pend;
      int j = rank0;
      for (unsigned m = ends; m; m &= m - 1) {
        const int p = __ffs(m) - 1;
        const unsigned below = starts & ((1u << p) - 1u);
        const int lo = below ? v0 + 31 - __clz(below) : before;
        if (live) {
          A.oe_valid[ob + j] = ev;
          A.oe_a[ob + j] = lo;
          A.oe_b[ob + j] = v0 + p - lo;
        }
        if (++j == per_nb) {
          sent = pend & ((1u << p) - 1u);
          break;
        }
      }
    }
    runs += seg_get(g, eincl, g.P - 1);
    const int ls = seg_get(g, sincl, g.P - 1);
    if (ls >= 0) open_lo = ls;
    carry = (unsigned)seg_get(g, (int)((pend >> 15) & 1u), g.P - 1);

    if (!live) continue;
    store16<kVec>(oor, v0, V, st ? Ob : (requeue ? Fb : Ob) & ~known);
    if (st) {
      store16<kVec>(opr, v0, V, Pb);
      store16<kVec>(ofr, v0, V, Fb);
    } else if (S.eager) {
      store16<kVec>(opr, v0, V, pend);
      store16<kVec>(ofr, v0, V, i2);
    } else {
      store16<kVec>(opr, v0, V, pend & ~sent);
      store16<kVec>(ofr, v0, V, i2 | sent);
    }
  }
  // a run still open ends at V; lanes past the last run are empty
  int used = min(runs, per_nb);
  if (carry && runs < per_nb) {
    if (live && g.sl == 0) {
      A.oe_valid[ob + runs] = ev;
      A.oe_a[ob + runs] = open_lo;
      A.oe_b[ob + runs] = V - open_lo;
    }
    ++used;
  }
  // the digest lane: the seen' bits of the window paid
  unsigned lo = 0u, hi = 0u;
  seen_window(A, S, g, I, ws, dacc, lo, hi);
  if (!live) return;
  for (int j = g.sl; j < per_nb; j += g.P) {
    if (j >= used) {
      A.oe_valid[ob + j] = 0;
      A.oe_a[ob + j] = 0;
      A.oe_b[ob + j] = 0;
    }
    A.oe_type[ob + j] = T_GRANGE;
    A.oe_c[ob + j] = 0;
  }
  if (g.sl != 0) return;
  const long long o = nd * S.Lout;
  A.oe_valid[o] = have && eok && !st;
  A.oe_type[o] = T_DIGEST;
  A.oe_a[o] = ws;
  A.oe_b[o] = (int)lo;
  A.oe_c[o] = (int)hi;
}

// Warp gw of the grid: below edge_warps, 32 / P edge rows n * D + d (P
// lanes each), then 32 / P node rows n. A warp's shared memory: the two
// tile masks.
template <bool kVec, bool kTiles>
__global__ void __launch_bounds__(kWarps * 32, 4)
    step_kernel(StepArgs A, StepDims S, int P, int edge_warps,
                int node_warps) {
  __shared__ unsigned smem[kWarps * kMaskArea];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + warp;
  if (gw >= edge_warps + node_warps) return;  // whole warps leave
  unsigned* mk = smem + warp * kMaskArea;
  mk[lane] = 0u;
  __syncwarp();
  const Seg g = make_seg(kTiles ? 32 : P);
  const int seg = lane / g.P, rows = 32 / g.P;
  if (gw < edge_warps) {
    const int ND = S.N * S.D, r = gw * rows + seg;
    const bool live = r < ND && (MT_K15_PART != 1 || S.N < 0);
    edge_row<kVec, kTiles>(A, S, g, mk, live ? r : ND - 1, live);
  } else {
    const int n = (gw - edge_warps) * rows + seg;
    const bool live = n < S.N && (MT_K15_PART != 1 || S.N < 0);
    node_row<kVec, kTiles>(A, S, g, mk, live ? n : S.N - 1, live);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kTiles>
cudaError_t launch(const StepArgs& args, const StepDims& dims, bool vec,
                   int P, int edge_warps, int node_warps,
                   cudaStream_t stream) {
  void (*kern)(StepArgs, StepDims, int, int, int) =
      vec ? &step_kernel<true, kTiles> : &step_kernel<false, kTiles>;
  kern<<<mt_blocks((long long)edge_warps + node_warps, kWarps),
         kWarps * 32, 0, stream>>>(args, dims, P, edge_warps, node_warps);
  return cudaGetLastError();
}

int launch_step(void* const* p, int n_ptrs, const long long* v, int n_ints,
                void* stream, bool with_stall) {
  if (mt_bad_args(n_ptrs, kStepPtrs - (with_stall ? 0 : 1), n_ints, 13))
    return cudaErrorInvalidValue;
  StepArgs args;
  memcpy(&args, p, sizeof(void*) * n_ptrs);
  if (!with_stall)
    args.stall = nullptr;
  else if (args.stall == nullptr)
    return cudaErrorInvalidValue;
  StepDims dims = {(int)v[0], (int)v[1], (int)v[2], (int)v[3], (int)v[4],
                   (int)v[5], (int)v[6], (int)v[7], (int)v[8], (int)v[9]};
  const long long P = v[10], edge_warps = v[11], node_warps = v[12];
  if (dims.Lout != dims.per_nb + 1 || dims.per_nb < 0 || dims.N < 0 ||
      dims.D < 1 || dims.retry == 0 || (long long)dims.W * 64 < dims.V)
    return cudaErrorInvalidValue;
  if (dims.N == 0) return cudaSuccess;
  // rows and tile offsets in int
  if ((long long)dims.N * (dims.D + 1) > 0x7fffffffLL - 32 * kWarps ||
      dims.V < 1 || dims.V > 0x7fffffff - 2 * kTile)
    return cudaErrorInvalidValue;
  // the plan (batched_plan): P lanes a row, the fewest 16-byte lanes that
  // cover V + 15 bytes, up to 32; past that 32 and 512-value tiles
  long long want = 1;
  while (want < 32 && 16 * want < dims.V + 15) want *= 2;
  const long long rows = 32 / want;
  if (P != want ||
      edge_warps != ((long long)dims.N * dims.D + rows - 1) / rows ||
      node_warps != (dims.N + rows - 1) / rows)
    return cudaErrorInvalidValue;
  const bool tiles = 16 * P < dims.V + 15;
  const bool vec = aligned16(args.seen) && aligned16(args.pending) &&
                   aligned16(args.inflight) &&
                   aligned16(args.inflight_old) && aligned16(args.o_seen) &&
                   aligned16(args.o_pending) && aligned16(args.o_inflight) &&
                   aligned16(args.o_inflight_old);
  const cudaStream_t st = (cudaStream_t)stream;
  return tiles ? launch<true>(args, dims, vec, (int)P, (int)edge_warps,
                              (int)node_warps, st)
               : launch<false>(args, dims, vec, (int)P, (int)edge_warps,
                               (int)node_warps, st);
}

}  // namespace

// ptrs: the fields of StepArgs in order but the last (stall); ints: the
// fields of StepDims, then the plan: P, edge warps, node warps
MT_API int mt_broadcast_batched_step(void* const* p, int n_ptrs,
                                     const long long* v, int n_ints,
                                     void* stream) {
  return launch_step(p, n_ptrs, v, n_ints, stream, false);
}

// K15 with the stall mask (enable_stall): ptrs: every field of StepArgs,
// the [N] stall mask last
MT_API int mt_broadcast_batched_step_stall(void* const* p, int n_ptrs,
                                           const long long* v, int n_ints,
                                           void* stream) {
  return launch_step(p, n_ptrs, v, n_ints, stream, true);
}
