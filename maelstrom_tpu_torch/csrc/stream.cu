// K18 sched_inject: the continuous scan's per-round select and fold.
//
// Replaces the sched_inject arms of _scan in maelstrom_tpu/sim.py
// (:847-930): before round k of a window the JAX body selects the rows
// of the window's [Q] inject batch scheduled at offset k,
//     inj.valid = inject.valid & (at_rounds == k),
// and after the round it folds the mids that _send stamped on them,
//     im = where(sent.valid, sent.mid, im).
// One launch a round does both: it folds round k-1's stamped view into a
// fresh im (im_in null means all -1: the window's first round) and writes
// round k's inject valid plane; the window's last fold launches with no
// inject output. Every output is a fresh tensor, so a rolled-back chunk
// restores im by keeping the tensor it started from.
//
// Bound: bytes. Q rows of inject valid, at, im, the stamped valid and
// mid read once, im and the inject valid written once: 15 bytes a row
// (plus 4 without a fold). At the main path's Q (the concurrency, 5 to
// 100,000) the launch latency dominates. One thread a row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sched_inject_kernel(const u8* inj_valid, const int* at,
                                    const int* im_in, const u8* sent_valid,
                                    const int* sent_mid, u8* out_valid,
                                    int* out_im, int Q, int off) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Q) return;
  int m = im_in != nullptr ? im_in[j] : -1;
  if (sent_valid != nullptr && sent_valid[j]) m = sent_mid[j];
  out_im[j] = m;
  if (out_valid != nullptr) out_valid[j] = inj_valid[j] && at[j] == off;
}

}  // namespace

// ptrs: inject valid [Q], at_rounds [Q], im [Q] (null: all -1), the
//       previous round's stamped valid [Q] and mid [Q] (both null: no
//       fold), the output inject valid [Q] (null: the last fold), the
//       output im [Q]
// ints: Q, the round's offset in the window
MT_API int mt_sched_inject(void* const* p, int n_ptrs, const long long* v,
                           int n_ints, void* stream) {
  if (mt_bad_args(n_ptrs, 7, n_ints, 2)) return cudaErrorInvalidValue;
  const int Q = (int)v[0];
  if (Q < 1 || (p[3] == nullptr) != (p[4] == nullptr))
    return cudaErrorInvalidValue;
  sched_inject_kernel<<<mt_blocks(Q, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const u8*)p[0], (const int*)p[1], (const int*)p[2], (const u8*)p[3],
      (const int*)p[4], (u8*)p[5], (int*)p[6], Q, (int)v[1]);
  return cudaGetLastError();
}
