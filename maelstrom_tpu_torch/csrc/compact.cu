// K4 reply compaction: the client replies of a round, compacted.
//
// Replaces the top_k compaction in maelstrom_tpu/sim.py:_round_edge
// (:496-510). Input: the [N * K] flattened client replies. Output: CC
// rows, the first CC valid rows in index order and, where fewer are
// valid, the lowest-index invalid rows after them with valid = 0 (the
// order jax.lax.top_k gives the zero-score ties). src = row / K, and
// mid = next_mid + (running count of valid output rows) - 1. Also
// returns n_all, the count of every valid reply.
//
// Bound: it reads the N * K valid bytes once (400 KB at 100k nodes, K 4)
// and gathers CC rows, well under a microsecond of memory time, so it is
// bound by its launches and their latency. Design: the rows are cut into
// segments of kSeg, one block each. The first launch counts each
// segment's valid rows (coalesced byte loads, a block reduction). The
// second gives each block the count of valid rows before its segment
// (a sum over the counts of the segments before it) and the total; a
// block whose segment holds no row of the CC slots returns at once, and
// the others walk their segment a tile of kThreads rows at a time, ranking
// rows with warp ballots, and stop as soon as no later row can land.
//
// Batched segments (the cluster axis, maelstrom_tpu/parallel/__init__.py
// make_cluster_round_fn: the compaction under vmap): F clusters of N * K
// rows each, every cluster compacted on its own into its own CC slots with
// its own next_mid and n_all. Segments never cross a cluster, so block b
// is segment b mod n_seg of cluster b / n_seg, and the two launches cover
// all F clusters.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16 * kThreads;  // rows a block

struct CompactArgs {
  const u8* valid;
  const int *dest, *due, *reply_to, *type, *a, *b, *c, *next_mid;
  u8* o_valid;
  int *o_src, *o_dest, *o_due, *o_mid, *o_reply_to, *o_type, *o_a, *o_b,
      *o_c, *n_all;
  int* seg_count;  // scratch [n_segments]
};
constexpr int kCompactPtrs = sizeof(CompactArgs) / sizeof(void*);

// sum of `x` over the block; every thread gets it
__device__ int block_sum(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__global__ void count_kernel(const u8* __restrict__ valid,
                             int* __restrict__ seg_count, long long NK,
                             int n_seg) {
  __shared__ int red[kWarps];
  const long long f = blockIdx.x / n_seg;
  valid += f * NK;
  const long long lo = (long long)(blockIdx.x % n_seg) * kSeg;
  int cnt = 0;
  for (long long i = lo + threadIdx.x; i < lo + kSeg && i < NK;
       i += kThreads)
    cnt += valid[i] != 0;
  cnt = block_sum(cnt, red);
  if (threadIdx.x == 0) seg_count[blockIdx.x] = cnt;
}

__global__ void emit_kernel(CompactArgs A, long long NK, int K, int CC,
                            int n_seg) {
  __shared__ int red[kWarps];
  __shared__ int warp_base[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // cluster f's rows, output slots, next_mid and n_all
  const long long f = blockIdx.x / n_seg;
  const int b = blockIdx.x % n_seg;
  const long long in = f * NK, o = f * CC;
  A.valid += in;
  A.dest += in; A.due += in; A.reply_to += in; A.type += in;
  A.a += in; A.b += in; A.c += in;
  A.o_valid += o;
  A.o_src += o; A.o_dest += o; A.o_due += o; A.o_mid += o;
  A.o_reply_to += o; A.o_type += o; A.o_a += o; A.o_b += o; A.o_c += o;
  A.next_mid += f;
  A.n_all += f;
  const int* seg_count = A.seg_count + f * n_seg;
  int before = 0, total = 0;
  for (int s = t; s < n_seg; s += kThreads) {
    const int c = seg_count[s];
    total += c;
    if (s < b) before += c;
  }
  before = block_sum(before, red);
  total = block_sum(total, red);
  const int taken = total < CC ? total : CC;
  if (b == 0 && t == 0) *A.n_all = total;
  const long long lo = (long long)b * kSeg;
  long long vr = before;  // valid rows before the current tile
  for (long long tile = lo; tile < lo + kSeg && tile < NK;
       tile += kThreads) {
    // no row from here on lands: every valid one ranks >= CC, and so
    // does every invalid one (uniform across the block)
    if (vr >= CC && total + (tile - vr) >= CC) break;
    const long long i = tile + t;
    const bool v = i < NK && A.valid[i] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, v);
    __syncthreads();  // warp_base may still be read by the last tile
    if (lane == 0) warp_base[warp] = __popc(m);
    __syncthreads();
    int wb = 0, tile_valid = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) wb += warp_base[w];
      tile_valid += warp_base[w];
    }
    if (i < NK) {
      const long long r = vr + wb + __popc(m & ((1u << lane) - 1u));
      const long long slot = v ? r : total + (i - r);
      if (slot < CC) {
        A.o_valid[slot] = v;
        A.o_src[slot] = (int)(i / K);
        A.o_dest[slot] = A.dest[i];
        A.o_due[slot] = A.due[i];
        A.o_mid[slot] = *A.next_mid + (int)(v ? slot : taken - 1);
        A.o_reply_to[slot] = A.reply_to[i];
        A.o_type[slot] = A.type[i];
        A.o_a[slot] = A.a[i];
        A.o_b[slot] = A.b[i];
        A.o_c[slot] = A.c[i];
      }
    }
    vr += tile_valid;
  }
}

}  // namespace

// ptrs: the fields of CompactArgs in order (the row fields [F, N * K],
//       next_mid and n_all [F], the outputs [F, CC])
// ints: N * K, K, CC (1 <= CC <= N * K), the length of the seg_count
//       scratch, which must hold F * ceil(N * K / 4096) entries, and F
MT_API int mt_reply_compact(void* const* p, int n_ptrs, const long long* v,
                            int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kCompactPtrs, n_ints, 5))
    return cudaErrorInvalidValue;
  CompactArgs args;
  memcpy(&args, p, sizeof(args));
  const long long NK = v[0], F = v[4];
  const int n_seg = (int)((NK + kSeg - 1) / kSeg);
  if (NK < 1 || F < 1 || F * n_seg > v[3] || v[2] < 1 || v[2] > NK
      || F * n_seg > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(F * n_seg);
  count_kernel<<<blocks, kThreads, 0, st>>>(args.valid, args.seg_count, NK,
                                            n_seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  emit_kernel<<<blocks, kThreads, 0, st>>>(args, NK, (int)v[1], (int)v[2],
                                           n_seg);
  return cudaGetLastError();
}
