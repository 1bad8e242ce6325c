// Sorted segmented SUM + MAX over f32 meter rows, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of deepflow_tpu/ops/segreduce_pallas.py:
//   * _gather_suffix_kernel (segreduce_pallas.py:117), launched through
//     sorted_segment_sum_max(..., perm=): rows are read THROUGH the sort
//     permutation, so the sorted payload is never written to memory;
//   * _suffix_kernel (segreduce_pallas.py:87): the same reduction over
//     rows that are already sorted (DEEPFLOW_FUSED_GATHER=0).
// One templated kernel, two launchers.
//
// What it computes: for every output segment k < cap, the column-wise
// sum (in row order) and max of rows[perm ? perm[r] : r] over the rows
// r whose ascending segment id seg[r] == k. first_pos[k] is the first
// such row (searchsorted-left of k over seg), so segment k spans
// [first_pos[k], first_pos[k+1]); the last segment walks seg to find its
// end. Rows of dead ids (>= cap) are never read.
//
// Design: one thread block per output segment, one thread per meter
// column (m <= 128, rounded up to whole warps). Neighbouring threads
// read neighbouring floats of one row, so each row read is one
// coalesced 4*m-byte access; the row loop is unrolled so several rows'
// loads are in flight at once. Each block writes its [m] sums and maxs
// directly: the TPU design's per-block suffix scans and cross-block
// carry pass (segreduce_pallas.py:244-275) have no counterpart, since
// first_pos already bounds every segment.
//
// Bound on the card: bytes. Each kept row is read once (4*m bytes plus
// its 4-byte id and, with the gather, its 4-byte perm entry), and
// 2*cap*m floats are written; two f32 operations per element are far
// below the compute rate. Short segments leave most of a block's loop
// latency-bound; widening the work per block is left to a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <bool GATHER>
__global__ void segreduce_kernel(const float* __restrict__ rows,
                                 const int* __restrict__ perm,
                                 const int* __restrict__ seg,
                                 const int* __restrict__ first_pos,
                                 float* __restrict__ sums,
                                 float* __restrict__ maxs,
                                 int n, int m, int cap) {
  const int k = blockIdx.x;
  const int col = threadIdx.x;
  int beg = first_pos[k];
  int end;
  if (k + 1 < cap) {
    end = first_pos[k + 1];
  } else {
    end = beg < 0 ? 0 : beg;
    while (end < n && seg[end] == k) ++end;
  }
  beg = beg < 0 ? 0 : (beg > n ? n : beg);
  end = end < beg ? beg : (end > n ? n : end);
  if (col >= m) return;

  float s = 0.0f;
  float mx = -INFINITY;
#pragma unroll 4
  for (int r = beg; r < end; ++r) {
    const long long row = GATHER ? static_cast<long long>(__ldg(perm + r))
                                 : static_cast<long long>(r);
    const float v = __ldg(rows + row * m + col);
    s += v;
    // NaN propagates like torch.amax / jnp.maximum
    mx = (v > mx || v != v) ? v : mx;
  }
  const long long o = static_cast<long long>(k) * m + col;
  sums[o] = s;
  maxs[o] = mx;
}

inline int threads_for(int m) { return ((m + 31) / 32) * 32; }

}  // namespace

extern "C" {

// Fused-gather variant: rows [n_rows, m] f32 in original order, perm [n]
// i32 (values < n_rows), seg [n] i32 ascending, first_pos [cap] i32;
// sums / maxs [cap, m] f32. Returns cudaGetLastError() after the launch.
int segreduce_gather_launch(const float* rows, const int* perm, const int* seg,
                            const int* first_pos, float* sums, float* maxs,
                            int n, int m, int cap, void* stream) {
  segreduce_kernel<true><<<cap, threads_for(m), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rows, perm, seg, first_pos, sums, maxs, n, m, cap);
  return static_cast<int>(cudaGetLastError());
}

// Pre-gathered variant: rows [n, m] f32 already in sorted order.
int segreduce_sorted_launch(const float* rows, const int* seg,
                            const int* first_pos, float* sums, float* maxs,
                            int n, int m, int cap, void* stream) {
  segreduce_kernel<false><<<cap, threads_for(m), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      rows, nullptr, seg, first_pos, sums, maxs, n, m, cap);
  return static_cast<int>(cudaGetLastError());
}

// Every kernel source exports this (kernels/build.py check_launch).
const char* df_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
