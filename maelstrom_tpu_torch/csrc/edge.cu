// K1 edge_read, K2 edge_write and K9 edge_write_spill: the static edge
// exchange.
//
// Replaces maelstrom_tpu/net/static.py:edge_read (:325) and the non-spill
// forms of maelstrom_tpu/net/static.py:edge_write (:168). Channels are
// [N, D, ring, L] planes (valid u8; type, a, b, c int32); the round's
// lanes are [N, D, L].
//
// Bound: both move a few tens of bytes per lane and compute almost
// nothing, so they are bound by device-memory bytes (about 30 MB a round
// at 100k nodes, D 4, L 2). Design: one thread per (node, edge, lane), so
// neighbouring threads touch neighbouring lanes and the L-wide runs of a
// cell; the round counter is read on the device, so a run of rounds needs
// no host sync.
//
// edge_read race: missing edges (nb < 0) are clipped to row (0, 0), so
// several threads may read that row while another thread clears it. The
// clear of cell `round % ring` is therefore a second launch on the same
// stream, after every route has read its cell.
//
// edge_write: each lane writes exactly one cell of its own (n, d, ., l)
// column, so no two threads write one cell, and the three JAX forms
// (uniform arrival, ring <= 4, broadcast select) are the same per-lane
// code. The counters are summed per block with __syncthreads_count and
// added with one atomicAdd each: integer sums, equal in any order. The
// latency and the deliver mask are read through their strides: on the
// round's path they are a broadcast scalar and an [N, D] mask, and an
// expanded copy of them would move more bytes than the write itself.
// On the cluster axis (F clusters' rows written in one launch) the two
// counters are arrays of F, one a cluster of rows_per_counter node rows:
// there each overwrite or clipped draw, rare events, is one atomicAdd on
// its cluster's counter.
//
// The `sent` plane (journaled runs only): K2 writes round * LANE_STRIDE +
// lane into each lane it writes (maelstrom_tpu/net/static.py:192-197) and
// K1 routes the plane with the other fields (:363). Both take it as an
// optional pointer; when it is null the test is one uniform branch and
// the bench path moves no more bytes than without it.
//
// Per-cluster rounds (the fleet's cluster axis, where every cluster keeps
// its own round): with rows_per_round > 0 the round pointer is an [F]
// array and node row n reads round[n / rows_per_round] (its cluster's),
// in K1's route and clear, K2's and K9's arrival cells and `sent` stamps;
// under uniform_arrival K2 takes the latency entry of its cluster's first
// row (JAX's entry 0 under vmap). rows_per_round 0 keeps the scalar round
// of one cluster, or of F clusters at one round.
//
// K9 edge_write_spill replaces
// maelstrom_tpu/net/static.py:_edge_write_spill (:267-322), the
// collision-free write that broadcast takes under randomized latency on
// 4,096 nodes or fewer. Cells are filled from lane 0
// up (edge_read clears whole cells), so an incoming lane goes to lane
// occ + rank of its arrival cell: occ the cell's occupancy before this
// write, rank the number of this round's earlier lanes (in out-lane order)
// aimed at the same cell. It is written when that lane is below the
// channel's Lc lanes, and counted in `overwrites` otherwise; clipped
// latency draws are counted as in K2, and a tracked `sent` plane takes
// round * LANE_STRIDE + out lane. Design: one thread a (node, edge), which
// owns every cell of its ring row, so the occupancies are read before any
// write of the round and no two threads touch one cell; the rank is the
// O(Lo^2) count of the JAX version. Bound: bytes (the out lanes, and Lc
// valid bytes of each targeted cell) and, at a handful of lanes, launch
// latency.
#include "common.cuh"

namespace {

constexpr int kLaneStride = 64;  // net/static.py LANE_STRIDE

// element strides of an [N, D, L] view; 0 where it is broadcast
struct Strides3 {
  long long s0, s1, s2;
};

__global__ void route_kernel(const u8* __restrict__ valid,
                             const int* __restrict__ type,
                             const int* __restrict__ a,
                             const int* __restrict__ b,
                             const int* __restrict__ c,
                             const int* __restrict__ nb,
                             const int* __restrict__ rev,
                             const int* __restrict__ round_ptr,
                             u8* __restrict__ o_valid, int* __restrict__ o_type,
                             int* __restrict__ o_a, int* __restrict__ o_b,
                             int* __restrict__ o_c,
                             const int* __restrict__ sent,
                             int* __restrict__ o_sent, int N, int D,
                             int ring, int L, int rows_per_round) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)N * D * L;
  if (i >= total) return;
  int l = (int)(i % L);
  long long me = i / L;  // m * D + e
  const int rnd =
      rows_per_round > 0 ? round_ptr[me / D / rows_per_round] : *round_ptr;
  int s = mt_mod(rnd, ring);
  int n = nb[me];
  int r = rev[me];
  long long row = (long long)mt_clip(n, 0, N - 1) * D + mt_clip(r, 0, D - 1);
  long long src = (row * ring + s) * L + l;
  o_valid[i] = (valid[src] != 0) && n >= 0;
  o_type[i] = type[src];
  o_a[i] = a[src];
  o_b[i] = b[src];
  o_c[i] = c[src];
  if (sent) o_sent[i] = sent[src];
}

__global__ void clear_kernel(u8* __restrict__ valid,
                             const int* __restrict__ round_ptr,
                             long long ND, int D, int ring, int L,
                             int rows_per_round) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ND * L) return;
  const int rnd = rows_per_round > 0
                      ? round_ptr[i / L / D / rows_per_round]
                      : *round_ptr;
  int s = mt_mod(rnd, ring);
  valid[((i / L) * ring + s) * L + i % L] = 0;
}

__global__ void write_kernel(u8* __restrict__ cv, int* __restrict__ ct,
                             int* __restrict__ ca, int* __restrict__ cb,
                             int* __restrict__ cc,
                             const u8* __restrict__ ov,
                             const int* __restrict__ ot,
                             const int* __restrict__ oa,
                             const int* __restrict__ ob,
                             const int* __restrict__ oc,
                             const int* __restrict__ lat,
                             const u8* __restrict__ mask,
                             const int* __restrict__ round_ptr,
                             int* __restrict__ overwrites,
                             int* __restrict__ lat_clipped,
                             int* __restrict__ cs, long long ND,
                             int D, int ring, int L, int uniform,
                             Strides3 ls, Strides3 ms,
                             long long rows_per_counter,
                             long long rows_per_round) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int ow = 0, clipped = 0;
  if (i < ND * L) {
    long long nd = i / L;
    long long n = nd / D;
    int d = (int)(nd % D), l = (int)(i % L);
    bool ok = ov[i] != 0 && mask[n * ms.s0 + d * ms.s1 + l * ms.s2] != 0;
    int lt = lat[n * ls.s0 + d * ls.s1 + l * ls.s2];
    const long long n0 =
        rows_per_round > 0 ? n / rows_per_round * rows_per_round : 0;
    int lr = uniform ? lat[n0 * ls.s0] : lt;  // uniform: entry 0's cell
    int off = mt_clip(lr, 0, ring - 1);
    off = off < 1 ? 1 : off;
    const int rnd =
        rows_per_round > 0 ? round_ptr[n / rows_per_round] : *round_ptr;
    int slot = mt_mod(rnd + off, ring);
    clipped = ok && lt > ring - 1;
    if (ok) {
      long long dst = ((i / L) * ring + slot) * L + i % L;
      ow = cv[dst] != 0;
      cv[dst] = 1;
      ct[dst] = ot[i];
      ca[dst] = oa[i];
      cb[dst] = ob[i];
      cc[dst] = oc[i];
      if (cs) cs[dst] = rnd * kLaneStride + l;
    }
  }
  if (rows_per_counter > 0) {  // uniform across the grid
    const long long k = i / L / D / rows_per_counter;
    if (ow) atomicAdd(overwrites + k, 1);
    if (clipped) atomicAdd(lat_clipped + k, 1);
    return;
  }
  int n_ow = __syncthreads_count(ow);
  int n_clip = __syncthreads_count(clipped);
  if (threadIdx.x == 0) {
    if (n_ow) atomicAdd(overwrites, n_ow);
    if (n_clip) atomicAdd(lat_clipped, n_clip);
  }
}

constexpr int kMaxLanes = 64;  // LANE_STRIDE

__global__ void spill_kernel(u8* __restrict__ cv, int* __restrict__ ct,
                             int* __restrict__ ca, int* __restrict__ cb,
                             int* __restrict__ cc,
                             const u8* __restrict__ ov,
                             const int* __restrict__ ot,
                             const int* __restrict__ oa,
                             const int* __restrict__ ob,
                             const int* __restrict__ oc,
                             const int* __restrict__ lat,
                             const u8* __restrict__ mask,
                             const int* __restrict__ round_ptr,
                             int* __restrict__ overwrites,
                             int* __restrict__ lat_clipped,
                             int* __restrict__ cs, long long ND, int D,
                             int ring, int Lc, int Lo, Strides3 ls,
                             Strides3 ms, long long rows_per_counter,
                             long long rows_per_round) {
  const long long nd = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int cnt[2] = {0, 0};  // overwrites, clipped
  if (nd < ND) {
    const long long n = nd / D;
    const int d = (int)(nd % D);
    const int round =
        rows_per_round > 0 ? round_ptr[n / rows_per_round] : *round_ptr;
    int cell[kMaxLanes], lane[kMaxLanes];
    // pass 1: arrival cells, ranks and occupancies, before any write
    for (int l = 0; l < Lo; ++l) {
      const bool ok = ov[nd * Lo + l] != 0 &&
                      mask[n * ms.s0 + d * ms.s1 + l * ms.s2] != 0;
      const int lt = lat[n * ls.s0 + d * ls.s1 + l * ls.s2];
      int off = mt_clip(lt, 0, ring - 1);
      off = off < 1 ? 1 : off;
      cnt[1] += ok && lt > ring - 1;
      cell[l] = ok ? mt_mod(round + off, ring) : -1;
      lane[l] = -1;
      if (!ok) continue;
      int rank = 0;
      for (int j = 0; j < l; ++j) rank += cell[j] == cell[l];
      const u8* cvalid = cv + (nd * ring + cell[l]) * Lc;
      int occ = 0;
      for (int m = 0; m < Lc; ++m) occ += cvalid[m] != 0;
      if (occ + rank < Lc)
        lane[l] = occ + rank;
      else
        ++cnt[0];
    }
    // pass 2: the writes
    for (int l = 0; l < Lo; ++l) {
      if (lane[l] < 0) continue;
      const long long dst = (nd * ring + cell[l]) * Lc + lane[l];
      const long long src = nd * Lo + l;
      cv[dst] = 1;
      ct[dst] = ot[src];
      ca[dst] = oa[src];
      cb[dst] = ob[src];
      cc[dst] = oc[src];
      if (cs) cs[dst] = round * kLaneStride + l;
    }
  }
  if (rows_per_counter > 0) {  // uniform across the grid
    if (nd < ND) {
      const long long k = nd / D / rows_per_counter;
      if (cnt[0]) atomicAdd(overwrites + k, cnt[0]);
      if (cnt[1]) atomicAdd(lat_clipped + k, cnt[1]);
    }
    return;
  }
  int* const dst[2] = {overwrites, lat_clipped};
  mt_block_add<2>(cnt, dst);
}

constexpr int kThreads = 256;

}  // namespace

// ptrs: ch.valid, ch.type, ch.a, ch.b, ch.c, neighbors, rev, round,
//       inbox.valid, inbox.type, inbox.a, inbox.b, inbox.c, ch.sent,
//       inbox.sent (the last two both null or both set)
// ints: N, D, ring, L, rows_per_round (0: round is a scalar; else an [F]
//       array, node row n reading round[n / rows_per_round])
MT_API int mt_edge_read(void* const* p, int n_ptrs, const long long* v,
                        int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, 15, n_ints, 5) || (p[13] == nullptr) !=
      (p[14] == nullptr) || v[4] < 0)
    return cudaErrorInvalidValue;
  int N = (int)v[0], D = (int)v[1], ring = (int)v[2], L = (int)v[3];
  const int rpr = (int)v[4];
  long long total = (long long)N * D * L;
  if (total == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  route_kernel<<<mt_blocks(total, kThreads), kThreads, 0, st>>>(
      (const u8*)p[0], (const int*)p[1], (const int*)p[2], (const int*)p[3],
      (const int*)p[4], (const int*)p[5], (const int*)p[6],
      (const int*)p[7], (u8*)p[8], (int*)p[9], (int*)p[10], (int*)p[11],
      (int*)p[12], (const int*)p[13], (int*)p[14], N, D, ring, L, rpr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  clear_kernel<<<mt_blocks(total, kThreads), kThreads, 0, st>>>(
      (u8*)p[0], (const int*)p[7], (long long)N * D, D, ring, L, rpr);
  return cudaGetLastError();
}

// ptrs: ch.valid, ch.type, ch.a, ch.b, ch.c, out.valid, out.type, out.a,
//       out.b, out.c, latency_rounds, deliver_mask, round, ch.overwrites,
//       ch.lat_clipped, ch.sent or null
// ints: N, D, ring, L, uniform_arrival, then the [N, D, L] element strides
//       of latency_rounds and of deliver_mask (3 each; 0 on a broadcast
//       axis, so a round's scalar latency and per-edge mask are read in
//       place, not expanded), then rows_per_counter (0: one scalar pair of
//       counters; else counter k counts node rows k * rows_per_counter ..),
//       then rows_per_round (as mt_edge_read's)
MT_API int mt_edge_write(void* const* p, int n_ptrs, const long long* v,
                         int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, 16, n_ints, 13) || v[11] < 0 || v[12] < 0)
    return cudaErrorInvalidValue;
  long long ND = v[0] * v[1];
  int D = (int)v[1], ring = (int)v[2], L = (int)v[3], uniform = (int)v[4];
  Strides3 ls = {v[5], v[6], v[7]}, ms = {v[8], v[9], v[10]};
  long long total = ND * L;
  if (total == 0) return cudaSuccess;
  write_kernel<<<mt_blocks(total, kThreads), kThreads, 0,
                 (cudaStream_t)stream>>>(
      (u8*)p[0], (int*)p[1], (int*)p[2], (int*)p[3], (int*)p[4],
      (const u8*)p[5], (const int*)p[6], (const int*)p[7], (const int*)p[8],
      (const int*)p[9], (const int*)p[10], (const u8*)p[11],
      (const int*)p[12], (int*)p[13], (int*)p[14], (int*)p[15], ND, D, ring,
      L, uniform, ls, ms, v[11], v[12]);
  return cudaGetLastError();
}

// ptrs: as mt_edge_write (the channels with Lc lanes, the out lanes with
//       Lo <= Lc lanes, latency_rounds and deliver_mask read through their
//       strides, round, ch.overwrites, ch.lat_clipped, ch.sent or null)
// ints: N, D, ring, Lc, Lo, then the [N, D, Lo] element strides of
//       latency_rounds and of deliver_mask, then rows_per_counter and
//       rows_per_round (as mt_edge_write's)
MT_API int mt_edge_write_spill(void* const* p, int n_ptrs,
                               const long long* v, int n_ints,
                               void* stream) {
  if (mt_bad_args(n_ptrs, 16, n_ints, 13) || v[11] < 0 || v[12] < 0)
    return cudaErrorInvalidValue;
  long long ND = v[0] * v[1];
  int D = (int)v[1], ring = (int)v[2], Lc = (int)v[3], Lo = (int)v[4];
  if (Lo > kMaxLanes || Lo > Lc) return cudaErrorInvalidValue;
  Strides3 ls = {v[5], v[6], v[7]}, ms = {v[8], v[9], v[10]};
  if (ND == 0) return cudaSuccess;
  spill_kernel<<<mt_blocks(ND, kThreads), kThreads, 0,
                 (cudaStream_t)stream>>>(
      (u8*)p[0], (int*)p[1], (int*)p[2], (int*)p[3], (int*)p[4],
      (const u8*)p[5], (const int*)p[6], (const int*)p[7], (const int*)p[8],
      (const int*)p[9], (const int*)p[10], (const u8*)p[11],
      (const int*)p[12], (int*)p[13], (int*)p[14], (int*)p[15], ND, D, ring,
      Lc, Lo, ls, ms, v[11], v[12]);
  return cudaGetLastError();
}
