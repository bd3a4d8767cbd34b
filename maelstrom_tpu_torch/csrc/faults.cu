// K8 edge_faults: the fault masks and draws of a round's edge sends.
//
// Replaces the edge fault block of maelstrom_tpu/sim.py:_round_edge
// (:545-610) and its four counters (:629-639). For every element of the
// draw shape [N, D, Ld] (Ld = the out lanes L, or 1 for programs whose
// lanes travel as one message, edge_atomic_rpc):
//   blocked  = component[n] != component[nb] (| block_matrix[group[n],
//              group[nb]] with directional grudges), on real edges only;
//   stalled  = the destination is down or paused and not blocked
//              (enable_stall), and counts as blocked;
//   lost     = uniform(k_loss) < p_loss;
//   deliver  = !blocked & !lost;
//   lat      = latency rounds from k_lat (randomized latency only; the
//              constant latency is one scalar the wrapper broadcasts);
//   dup      = deliver & uniform(k_dup) < p_dup and dup_lat from k_dlat
//              (enable_duplication).
// The draws index the key streams by the element's flat index, as
// jax.random does over the draw shape. Counters over the out lanes'
// valid bits: lost (valid & !blocked & lost), dropped_partition (valid &
// blocked & !stalled), dropped_down (valid & stalled), duplicated (valid
// & dup), block-summed into a scratch of four, then one finishing thread
// writes the new counters (old + sums) into fresh scalars, so the round
// never updates its input state in place.
//
// The cluster axis (the fleet: F clusters' rounds in one launch, JAX's
// vmap of the block): the draw shape is [F, N, D, Ld] and cluster f reads
// its own row of every input, its component labels, groups, block matrix
// and down and paused masks (in local node ids: the neighbour table is
// the [N, D] table of one cluster), its keys, loss and duplication
// probabilities and latency scale, and books its own four counters. Its
// draws hash counter (n * D + d) * Ld + j under its own keys, as
// jax.random under vmap does; F = 1 is the single cluster.
//
// Bound: up to four threefry draws (about 80 integer operations each) an
// element against some 20 bytes read and written, so operations bound
// it. Design: one thread an element; the per-edge partition lookups are
// repeated by the Ld threads of an edge, reading neighbouring words.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// every per-cluster input and output leads with the F clusters
struct FaultArgs {
  const int* neighbors;       // [N, D], one cluster's table
  const int* component;       // [F, C] (C = N + clients)
  const int* block_groups;    // [F, C], null unless G > 1
  const u8* block_matrix;     // [F, G, G], null unless G > 1
  const u8* down;             // [F, N], null unless enable_stall
  const u8* paused;           // [F, N], null unless enable_stall
  const u8* valid;            // out lanes [F, N, D, L]
  const unsigned *k_loss, *k_lat, *k_dup, *k_dlat;  // uint32 [F, 2] keys
  const float *p_loss, *p_dup, *scale;              // float32 [F]
  const int *lost, *dropped_partition, *dropped_down, *duplicated;  // [F]
  int* acc;                   // [F, 4] scratch
  u8* deliver;                // [F, N, D, Ld]
  int* lat;                   // [F, N, D, Ld], null for constant latency
  u8* dup;                    // [F, N, D, Ld], null without duplication
  int* dup_lat;               // [F, N, D, Ld], null unless both
  int *o_lost, *o_dropped_partition, *o_dropped_down, *o_duplicated;  // [F]
};
constexpr int kFaultPtrs = sizeof(FaultArgs) / sizeof(void*);

struct FaultDims {
  int N, D, L, Ld, G, dist;
  float mean;
  int F, C;
};

__global__ void faults_kernel(FaultArgs A, FaultDims S) {
  const long long per = (long long)S.N * S.D * S.Ld;  // a cluster
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int cnt[4] = {0, 0, 0, 0};
  long long f = 0;
  if (i < per * S.F) {
    f = i / per;
    const long long il = i - f * per;  // the cluster's own draw index
    const long long nd = il / S.Ld;    // local (node, edge)
    const int j = (int)(il % S.Ld);
    const int n = (int)(nd / S.D);
    const int nb = A.neighbors[nd];
    const int snb = mt_clip(nb, 0, S.N - 1);
    const int* comp = A.component + f * S.C;
    bool blocked = comp[n] != comp[snb];
    if (A.block_matrix) {
      const int* bg = A.block_groups + f * S.C;
      blocked = blocked ||
                A.block_matrix[f * S.G * S.G + (long long)bg[n] * S.G +
                               bg[snb]] != 0;
    }
    blocked = blocked && nb >= 0;
    bool stalled = false;
    if (A.down) {
      const long long dn = f * S.N + snb;
      stalled = (A.down[dn] || A.paused[dn]) && nb >= 0 && !blocked;
    }
    blocked = blocked || stalled;
    const unsigned long long c = (unsigned long long)il;
    const bool lost =
        mt_unit(mt_random_bits(A.k_loss + 2 * f, c)) < A.p_loss[f];
    const bool del = !blocked && !lost;
    A.deliver[i] = del;
    const float mean = __fmul_rn(S.mean, A.scale[f]);
    if (A.lat)
      A.lat[i] = mt_latency(mt_unit(mt_random_bits(A.k_lat + 2 * f, c)),
                            S.dist, mean);
    bool dm = false;
    if (A.dup) {
      dm = del && mt_unit(mt_random_bits(A.k_dup + 2 * f, c)) < A.p_dup[f];
      A.dup[i] = dm;
      if (A.dup_lat)
        A.dup_lat[i] = mt_latency(
            mt_unit(mt_random_bits(A.k_dlat + 2 * f, c)), S.dist, mean);
    }
    const int l0 = S.Ld == S.L ? j : 0, l1 = S.Ld == S.L ? j + 1 : S.L;
    const long long row = f * S.N * S.D + nd;
    for (int l = l0; l < l1; ++l) {
      const bool v = A.valid[row * S.L + l] != 0;
      cnt[0] += v && !blocked && lost;
      cnt[1] += v && blocked && !stalled;
      cnt[2] += v && stalled;
      cnt[3] += v && dm;
    }
  }
  if (S.F > 1) {  // uniform across the grid: a block may span clusters
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (cnt[k]) atomicAdd(A.acc + 4 * f + k, cnt[k]);
    return;
  }
  int* const dst[4] = {A.acc, A.acc + 1, A.acc + 2, A.acc + 3};
  mt_block_add<4>(cnt, dst);
}

__global__ void faults_finish(FaultArgs A, int F) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  A.o_lost[f] = A.lost[f] + A.acc[4 * f];
  A.o_dropped_partition[f] = A.dropped_partition[f] + A.acc[4 * f + 1];
  A.o_dropped_down[f] = A.dropped_down[f] + A.acc[4 * f + 2];
  A.o_duplicated[f] = A.duplicated[f] + A.acc[4 * f + 3];
}

}  // namespace

// ptrs: the fields of FaultArgs in order; ints: N, D, L, Ld, G, dist,
// float32 bits of the mean latency in rounds, F (clusters), C (the length
// of a cluster's component and group rows)
MT_API int mt_edge_faults(void* const* p, int n_ptrs, const long long* v,
                          int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kFaultPtrs, n_ints, 9) || v[7] < 1 || v[8] < v[0])
    return cudaErrorInvalidValue;
  FaultArgs A;
  memcpy(&A, p, sizeof(A));
  const unsigned mbits = (unsigned)v[6];
  FaultDims S = {(int)v[0], (int)v[1], (int)v[2], (int)v[3], (int)v[4],
                 (int)v[5], 0.0f, (int)v[7], (int)v[8]};
  memcpy(&S.mean, &mbits, sizeof(S.mean));
  if ((A.block_matrix == nullptr) != (A.block_groups == nullptr) ||
      (A.down == nullptr) != (A.paused == nullptr) ||
      (A.lat != nullptr) != (S.dist != 0) ||
      (A.dup != nullptr && A.k_dup == nullptr) ||
      (A.dup_lat != nullptr && (A.dup == nullptr || A.lat == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(A.acc, 0, 4 * sizeof(int) * (size_t)S.F, st);
  if (err != cudaSuccess) return err;
  const long long total = (long long)S.N * S.D * S.Ld * S.F;
  if (total > 0) {
    faults_kernel<<<mt_blocks(total, kThreads), kThreads, 0, st>>>(A, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  faults_finish<<<mt_blocks(S.F, kThreads), kThreads, 0, st>>>(A, S.F);
  return cudaGetLastError();
}
