// K16 elle_edges and K17 elle_screen: the device-resident Elle checker's
// dependency-edge build and cycle screen.
//
// K16 replaces edges_fn / _edge_candidates (maelstrom_tpu/checkers/
// elle_device.py:184-205, 217-219): over the writer table (writers,
// slot_key [Vp]) and the read table (r_tid, wr_pos, rw_pos [Rp]) it writes
// the candidate rows (src, dst, kind, valid) [Vp-1 + 2 Rp]: rows
// [0, Vp-1) the ww pairs of consecutive writers inside a key's span, then
// Rp wr rows (the writer of the version a read observed -> the reader),
// then Rp rw rows (the reader -> the writer of the next version). A
// position gathers clamped into the table, as XLA's gathers do. One
// thread a row.
//
// K17 replaces screen_fn (maelstrom_tpu/checkers/elle_device.py:221-296):
// label propagation to a fixed point over phi [Tp]. The data stage seeds
// phi with the version potential (a scatter-max of 2*slot_idx+1 by writer
// and 2*r_n by reader, floored at 0) and steps
//   phi' = max(phi, segment_max over valid edges of phi[src]+1 -> dst);
// the realtime stage seeds phi with the ret rank and steps
//   phi' = max(data step, rt bound), rt_bound[t] = m[before[t]] + 1,
// m the inclusive prefix max of phi in ret order (ret_tid [Tp]). A stage
// iterates while its violation count (edges with phi[src] >= phi[dst],
// plus txns with phi < rt_bound in the realtime stage) is positive, phi
// changed, and fewer than `cap` steps ran; the count is taken on the new
// phi. Steps are Jacobi: the step reads phi and writes a copy (nphi), so
// iteration counts equal the JAX loop's. The loop runs in the C entry
// point, on the host, reading the two-word flag (violations, changed)
// once an iteration; the out words are (data acyclic, full acyclic, data
// iterations, full iterations). With do_rt 0 the realtime stage is
// skipped (0, 0).
//
// The prefix max is block-wise: each block of 1024 scans its labels in
// shared memory and writes its maximum to a carry; one block turns the
// carries into exclusive prefix maxima (a loop over chunks of 1024); a
// third pass folds each block's carry into its labels.
//
// Bound: bytes. K16 reads the five input planes once and writes 13 bytes
// a row. K17's inputs are read once a pass; its scratch (the compacted
// edge list, phi, nphi, m) is its own cost.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScan = 1024;
constexpr int kNeg = -(1 << 30);

struct EdgeIn {
  const int *writers, *slot_key, *r_tid, *wr_pos, *rw_pos;
  int vp, rp;
};

// candidate row e: (src, dst, kind, valid)
__device__ __forceinline__ void candidate(const EdgeIn& A, long long e,
                                          int& s, int& d, int& k, bool& ok) {
  const long long nww = A.vp - 1;
  if (e < nww) {
    const int a = A.writers[e], b = A.writers[e + 1];
    const int ka = A.slot_key[e], kb = A.slot_key[e + 1];
    s = a;
    d = b;
    k = 0;
    ok = ka == kb && kb >= 0 && a >= 0 && b >= 0 && a != b;
    return;
  }
  const bool wr = e < nww + A.rp;
  const int r = (int)(wr ? e - nww : e - nww - A.rp);
  const int p = wr ? A.wr_pos[r] : A.rw_pos[r];
  const int t = A.r_tid[r];
  const int w = A.writers[mt_clip(p, 0, A.vp - 1)];
  s = wr ? w : t;
  d = wr ? t : w;
  k = wr ? 1 : 2;
  ok = p >= 0 && t >= 0 && w >= 0 && w != t;
}

__global__ void edges_kernel(EdgeIn A, int* src, int* dst, int* kind,
                             u8* valid, long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  int s, d, k;
  bool ok;
  candidate(A, e, s, d, k, ok);
  src[e] = s;
  dst[e] = d;
  kind[e] = k;
  valid[e] = ok;
}

// the screen's edge list: src and dst of a valid row, -1 for an invalid
__global__ void compact_kernel(EdgeIn A, int* src_c, int* dst_c,
                               long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  int s, d, k;
  bool ok;
  candidate(A, e, s, d, k, ok);
  src_c[e] = ok ? s : -1;
  dst_c[e] = ok ? d : -1;
}

// version potential: phi (zeroed) max= 2*slot_idx+1 by writer over the
// Vp slots, then 2*r_n by reader over the Rp reads
__global__ void seed_data_kernel(const int* writers, const int* slot_idx,
                                 const int* r_tid, const int* r_n, int* phi,
                                 int vp, int rp) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < vp) {
    const int w = writers[i];
    if (w >= 0) atomicMax(&phi[w], (int)(2u * (unsigned)slot_idx[i] + 1u));
  } else if (i < (long long)vp + rp) {
    const int r = (int)(i - vp);
    const int t = r_tid[r];
    if (t >= 0) atomicMax(&phi[t], (int)(2u * (unsigned)r_n[r]));
  }
}

// ret-rank potential: phi (zeroed) max= position + 1 by ret_tid
__global__ void seed_rank_kernel(const int* ret_tid, int* phi, int tp) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= tp) return;
  const int t = ret_tid[i];
  if (t >= 0) atomicMax(&phi[t], i + 1);
}

// nphi (a copy of phi) max= phi[src] + 1 at dst over the valid edges
__global__ void step_edges_kernel(const int* src_c, const int* dst_c,
                                  const int* phi, int* nphi, long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int s = src_c[e];
  if (s >= 0) atomicMax(&nphi[dst_c[e]], phi[s] + 1);
}

// nphi[t] max= m[before[t]] + 1 (m: phi's prefix max in ret order)
__global__ void step_rt_kernel(const int* before, const int* m, int* nphi,
                               int tp) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= tp) return;
  const int b = before[t];
  if (b >= 0) nphi[t] = max(nphi[t], m[b] + 1);
}

// m = phi in ret order (NEG for padding), scanned within each block of
// kScan; carry[block] = the block's maximum
__global__ void scan_blocks_kernel(const int* ret_tid, const int* phi, int* m,
                                   int* carry, int tp) {
  __shared__ int buf[kScan];
  const int i = blockIdx.x * kScan + threadIdx.x;
  int v = kNeg;
  if (i < tp) {
    const int t = ret_tid[i];
    v = t >= 0 ? phi[t] : kNeg;
  }
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < kScan; off <<= 1) {
    const int o = threadIdx.x >= off ? buf[threadIdx.x - off] : kNeg;
    __syncthreads();
    buf[threadIdx.x] = max(buf[threadIdx.x], o);
    __syncthreads();
  }
  if (i < tp) m[i] = buf[threadIdx.x];
  if (threadIdx.x == kScan - 1) carry[blockIdx.x] = buf[kScan - 1];
}

// carry[b] <- max of carry[0..b) (NEG for the first), one block walking
// the carries in chunks of kScan
__global__ void scan_carries_kernel(int* carry, int nb) {
  __shared__ int buf[kScan];
  __shared__ int run;
  if (threadIdx.x == 0) run = kNeg;
  __syncthreads();
  for (int base = 0; base < nb; base += kScan) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? carry[i] : kNeg;
    buf[threadIdx.x] = v;
    __syncthreads();
    for (int off = 1; off < kScan; off <<= 1) {
      const int o = threadIdx.x >= off ? buf[threadIdx.x - off] : kNeg;
      __syncthreads();
      buf[threadIdx.x] = max(buf[threadIdx.x], o);
      __syncthreads();
    }
    const int excl = max(run, threadIdx.x > 0 ? buf[threadIdx.x - 1] : kNeg);
    if (i < nb) carry[i] = excl;
    __syncthreads();
    if (threadIdx.x == 0) run = max(run, buf[kScan - 1]);
    __syncthreads();
  }
}

__global__ void add_carries_kernel(int* m, const int* carry, int tp) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= tp) return;
  m[i] = max(m[i], carry[i / kScan]);
}

// flags[0] += the edges with phi[src] >= phi[dst]
__global__ void viol_edges_kernel(const int* src_c, const int* dst_c,
                                  const int* phi, int* flags, long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool bad = false;
  if (e < n) {
    const int s = src_c[e];
    bad = s >= 0 && phi[s] >= phi[dst_c[e]];
  }
  const int c = __syncthreads_count(bad);
  if (threadIdx.x == 0 && c) atomicAdd(&flags[0], c);
}

// flags[0] += the txns below their rt bound (with m: phi's prefix max);
// flags[1] = 1 where phi differs from old (old may be null)
__global__ void viol_txns_kernel(const int* before, const int* m,
                                 const int* phi, const int* old, int* flags,
                                 int tp, int do_rt) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  bool bad = false, moved = false;
  if (t < tp) {
    if (do_rt) {
      const int b = before[t];
      bad = b >= 0 && phi[t] < m[b] + 1;
    }
    moved = old != nullptr && phi[t] != old[t];
  }
  const int c = __syncthreads_count(bad);
  const int mv = __syncthreads_or(moved);
  if (threadIdx.x == 0) {
    if (c) atomicAdd(&flags[0], c);
    if (mv) flags[1] = 1;
  }
}

struct ScreenArgs {
  const int *writers, *slot_key, *slot_idx, *r_tid, *r_n, *wr_pos, *rw_pos,
      *ret_tid, *before;
  int* out;      // [4]
  int *src_c, *dst_c;  // [Vp-1 + 2 Rp] scratch
  int *phi, *nphi, *m;  // [Tp] scratch
  int* carry;    // [ceil(Tp / 1024)] scratch
  int* flags;    // [2] scratch
};
constexpr int kScreenPtrs = sizeof(ScreenArgs) / sizeof(void*);

struct Screen {
  ScreenArgs A;
  int vp, rp, tp;
  long long n;
  cudaStream_t st;

  int prefix_max(const int* phi) {
    const int nb = (tp + kScan - 1) / kScan;
    scan_blocks_kernel<<<nb, kScan, 0, st>>>(A.ret_tid, phi, A.m, A.carry,
                                             tp);
    scan_carries_kernel<<<1, kScan, 0, st>>>(A.carry, nb);
    add_carries_kernel<<<mt_blocks(tp, kThreads), kThreads, 0, st>>>(
        A.m, A.carry, tp);
    return (int)cudaGetLastError();
  }

  // (violations, changed) of phi against old (null: changed = 0), read
  // back to the host
  int viol(const int* phi, const int* old, int do_rt, int* host) {
    cudaMemsetAsync(A.flags, 0, 2 * sizeof(int), st);
    if (n > 0)
      viol_edges_kernel<<<mt_blocks(n, kThreads), kThreads, 0, st>>>(
          A.src_c, A.dst_c, phi, A.flags, n);
    viol_txns_kernel<<<mt_blocks(tp, kThreads), kThreads, 0, st>>>(
        A.before, A.m, phi, old, A.flags, tp, do_rt);
    int err = (int)cudaGetLastError();
    if (err) return err;
    cudaMemcpyAsync(host, A.flags, 2 * sizeof(int), cudaMemcpyDeviceToHost,
                    st);
    return (int)cudaStreamSynchronize(st);
  }

  // one stage from the seed in A.phi: returns the error; *iters, *v out
  int fixpoint(int cap, int do_rt, int* iters, int* v) {
    int host[2];
    int err = do_rt ? prefix_max(A.phi) : 0;
    if (!err) err = viol(A.phi, nullptr, do_rt, host);
    if (err) return err;
    int it = 0, changed = 1;
    while (host[0] > 0 && changed && it < cap) {
      cudaMemcpyAsync(A.nphi, A.phi, (size_t)tp * sizeof(int),
                      cudaMemcpyDeviceToDevice, st);
      if (n > 0)
        step_edges_kernel<<<mt_blocks(n, kThreads), kThreads, 0, st>>>(
            A.src_c, A.dst_c, A.phi, A.nphi, n);
      if (do_rt) {
        // the rt bound of the old phi (A.m holds its prefix max)
        step_rt_kernel<<<mt_blocks(tp, kThreads), kThreads, 0, st>>>(
            A.before, A.m, A.nphi, tp);
        err = prefix_max(A.nphi);
        if (err) return err;
      }
      err = viol(A.nphi, A.phi, do_rt, host);
      if (err) return err;
      changed = host[1];
      int* t = A.phi;
      A.phi = A.nphi;
      A.nphi = t;
      ++it;
    }
    *iters = it;
    *v = host[0];
    return 0;
  }
};

}  // namespace

// ptrs: writers, slot_key, r_tid, wr_pos, rw_pos, src, dst, kind, valid;
// ints: Vp, Rp
MT_API int mt_elle_edges(void* const* ptrs, int n_ptrs, const long long* ints,
                         int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, 9, n_ints, 2)) return cudaErrorInvalidValue;
  EdgeIn A{(const int*)ptrs[0], (const int*)ptrs[1], (const int*)ptrs[2],
           (const int*)ptrs[3], (const int*)ptrs[4], (int)ints[0],
           (int)ints[1]};
  const long long n = (long long)A.vp - 1 + 2LL * A.rp;
  if (n > 0)
    edges_kernel<<<mt_blocks(n, kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(A, (int*)ptrs[5], (int*)ptrs[6],
                                           (int*)ptrs[7], (u8*)ptrs[8], n);
  return (int)cudaGetLastError();
}

// ptrs: ScreenArgs in order; ints: Vp, Rp, Tp, do_rt, cap
MT_API int mt_elle_screen(void* const* ptrs, int n_ptrs,
                          const long long* ints, int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, kScreenPtrs, n_ints, 5))
    return cudaErrorInvalidValue;
  Screen S;
  memcpy(&S.A, ptrs, sizeof(ScreenArgs));
  S.vp = (int)ints[0];
  S.rp = (int)ints[1];
  S.tp = (int)ints[2];
  const int do_rt = (int)ints[3], cap = (int)ints[4];
  S.n = (long long)S.vp - 1 + 2LL * S.rp;
  S.st = (cudaStream_t)stream;
  const ScreenArgs& A = S.A;
  EdgeIn E{A.writers, A.slot_key, A.r_tid, A.wr_pos, A.rw_pos, S.vp, S.rp};
  if (S.n > 0)
    compact_kernel<<<mt_blocks(S.n, kThreads), kThreads, 0, S.st>>>(
        E, A.src_c, A.dst_c, S.n);
  // data stage: version-potential seed
  cudaMemsetAsync(S.A.phi, 0, (size_t)S.tp * sizeof(int), S.st);
  seed_data_kernel<<<mt_blocks((long long)S.vp + S.rp, kThreads), kThreads,
                     0, S.st>>>(A.writers, A.slot_idx, A.r_tid, A.r_n,
                                S.A.phi, S.vp, S.rp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int it_a = 0, v_a = 0, it_b = 0, v_b = 1;
  err = S.fixpoint(cap, 0, &it_a, &v_a);
  if (err) return err;
  if (do_rt) {
    // realtime stage: ret-rank seed
    cudaMemsetAsync(S.A.phi, 0, (size_t)S.tp * sizeof(int), S.st);
    seed_rank_kernel<<<mt_blocks(S.tp, kThreads), kThreads, 0, S.st>>>(
        A.ret_tid, S.A.phi, S.tp);
    err = (int)cudaGetLastError();
    if (err) return err;
    err = S.fixpoint(cap, 1, &it_b, &v_b);
    if (err) return err;
  }
  const int host[4] = {v_a == 0, do_rt && v_b == 0, it_a, it_b};
  cudaMemcpyAsync(A.out, host, sizeof(host), cudaMemcpyHostToDevice, S.st);
  err = (int)cudaStreamSynchronize(S.st);
  return err ? err : (int)cudaGetLastError();
}
