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
// [first_pos[k], first_pos[k+1]); the last segment searches seg for its
// end. Rows of dead ids (>= cap) are never read. Absent segments are not
// written: their output rows hold whatever the buffer held (the wrapper's
// contract).
//
// What bounds it on this card: bytes — each kept row read once (4*m
// bytes, plus its perm entry with the gather), first_pos once, and the
// live segments' sums and maxs written once; two f32 operations per
// element are far below the compute rate. The gathered rows are 248
// bytes at random addresses, so the bytes arrive only with many rows in
// flight. The first design (one block per segment, one thread per
// column) had a few rows in flight per block behind a chain of three
// dependent loads (first_pos, perm, row), and at the fold shape, where
// most segments hold 1-8 rows or none, it reached a quarter of the bound.
//
// This design has two paths; the launcher picks one from the static
// shape (n / cap, the mean rows a segment may hold):
//   * short segments (the fold, 5): each WARP takes a span of `span`
//     consecutive segments (sized so that a warp gets a few dozen rows)
//     and streams the span's rows [first_pos[k0], first_pos[k0+span])
//     through a ring of kStages batches of kBatch rows in shared memory.
//     A batch's perm entries are one coalesced load (one lane each),
//     prefetched ahead; its rows are copied with cp.async, Hopper's
//     asynchronous copy, in 8-byte pieces (4-byte ones for an odd m), so
//     the next batch is in flight while the warp reduces this one. The
//     warp sums each row, in ascending row order, into float2 lanes
//     across the columns (two pairs per lane cover m <= 128), and writes
//     a segment's sums and maxs when its rows end. A span without rows
//     exits after its first_pos read.
//   * long segments (the pre-reduce, 64): one block per segment, one
//     thread per column, four rows in flight per thread — the first
//     design, which already ran at about 60% of this shape's bound; the
//     span kernel, with fewer rows in flight per SM once its ring fills
//     shared memory, ran it slower.
// Both sum in row order, take the max in one NaN-propagating instruction,
// search the last segment's end with a 32-way warp search, and neither
// reduce nor write an absent segment.
//
// What it does not try: splitting one segment's rows across warps (the
// sums would change order, and the card's SUM lanes would drift from the
// CPU's), or TMA bulk copies (a gathered row is one 248-byte piece at a
// random address, not a tile).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // warps per block
constexpr int kBatch = 8;        // rows per staged batch
constexpr int kStages = 2;       // batches in each warp's ring
constexpr int kRowsPerWarp = 64; // rows a warp's span aims at
constexpr int kMaxSpan = 31;     // a span's heads live one per lane
// Segments this long on average (n / cap) take the block-per-segment
// kernel: the pre-reduce shape (64) does, the fold shape (5) does not.
constexpr int kLongRows = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Floats per staged row: m rounded up to a whole pair, so that pairs
// stay 8-byte aligned and the last pair of an odd m stays in its slot.
__host__ __device__ constexpr int slot_floats(int m) { return (m + 1) & ~1; }

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// max that propagates NaN like torch.amax / jnp.maximum, in one
// instruction (sm_80 and later)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// First index in [lo, hi) whose seg id is > k (hi if none), over an
// ascending seg: each round, the 32 lanes probe evenly spaced rows, so
// the range shrinks 32-fold and a segment of L rows ends in
// ceil(log32 L) rounds.
__device__ int warp_upper_bound(const int* __restrict__ seg, int lo, int hi, int k,
                                int lane) {
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const long long q = static_cast<long long>(lo) + static_cast<long long>(lane + 1) * step - 1;
    const bool in = q < hi && __ldg(seg + q) <= k;
    const int c = __popc(__ballot_sync(kFull, in));
    if (c == 0) {
      hi = lo + step - 1;
    } else {
      const long long last_in = static_cast<long long>(lo) + static_cast<long long>(c) * step - 1;
      const long long first_out = last_in + step;
      lo = static_cast<int>(last_in + 1);
      if (c < 32 && first_out < hi) hi = static_cast<int>(first_out);
    }
  }
  return lo;
}

__device__ __forceinline__ void fold_pair(float2 v, float2& s, float2& mx) {
  s.x += v.x;
  s.y += v.y;
  mx.x = max_nan(mx.x, v.x);
  mx.y = max_nan(mx.y, v.y);
}

template <int PIECE>
__device__ __forceinline__ float2 load_pair(const float* p) {
  if (PIECE == 8) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], p[1]);
}

template <int PIECE>
__device__ __forceinline__ void store_pair(float* out, int c, int m, float2 v) {
  if (PIECE == 8) {  // m even: the pair is 8-byte aligned
    if (c < m) *reinterpret_cast<float2*>(out + c) = v;
  } else {
    if (c < m) out[c] = v.x;
    if (c + 1 < m) out[c + 1] = v.y;
  }
}

template <bool GATHER, int PIECE>
__global__ void __launch_bounds__(kWarps * 32)
    segreduce_span_kernel(const float* __restrict__ rows, const int* __restrict__ perm,
                          const int* __restrict__ seg, const int* __restrict__ first_pos,
                          float* __restrict__ sums, float* __restrict__ maxs, int n, int m,
                          int cap, int span) {
  extern __shared__ __align__(16) float ring_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long k0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * span;
  if (k0 >= cap) return;
  const int nseg = static_cast<int>(min(static_cast<long long>(span), cap - k0));

  // lane l < nseg holds the head of segment k0 + l, lane nseg the end of
  // the span's last segment, all clamped to [0, n]
  int h = 0;
  if (lane < nseg || (lane == nseg && k0 + nseg < cap)) h = __ldg(first_pos + k0 + lane);
  h = h < 0 ? 0 : (h > n ? n : h);
  if (k0 + nseg == cap) {  // the span holds segment cap - 1: search its end
    const int beg = __shfl_sync(kFull, h, nseg - 1);
    const int end = warp_upper_bound(seg, beg, n, cap - 1, lane);
    if (lane == nseg) h = end;
  }
  const int rb = __shfl_sync(kFull, h, 0);
  const int re = max(rb, __shfl_sync(kFull, h, nseg));
  if (rb >= re) return;  // every segment of the span is absent

  const int slot = slot_floats(m);
  float* ring = ring_all + warp * (kStages * kBatch * slot);

  auto index_of = [&](int b) -> int {  // lane's row of batch b, in `rows`
    const int r = rb + b * kBatch + lane;
    if (lane >= kBatch || r >= re) return 0;
    return GATHER ? __ldg(perm + r) : r;
  };
  auto fetch = [&](int b, int idx) {  // batch b's rows → ring stage b % kStages
    const int base = rb + b * kBatch;
    const int cnt = min(kBatch, re - base);
    float* dst = ring + (b % kStages) * (kBatch * slot);
    for (int rr = 0; rr < cnt; ++rr) {
      const float* src = rows + static_cast<long long>(__shfl_sync(kFull, idx, rr)) * m;
      float* row = dst + rr * slot;
      for (int q = lane; q < m * 4 / PIECE; q += 32)
        cp_async<PIECE>(row + q * (PIECE / 4), src + q * (PIECE / 4));
    }
  };

  const int c0 = 2 * lane, c1 = 64 + 2 * lane;
  const float2 zero = make_float2(0.0f, 0.0f);
  const float2 ninf = make_float2(-INFINITY, -INFINITY);
  float2 s0 = zero, s1 = zero, x0 = ninf, x1 = ninf;
  bool any = false;
  int cur = 0;  // the span's segment being reduced
  int cur_end = max(rb, __shfl_sync(kFull, h, 1));
  auto emit = [&]() {
    if (any) {
      const long long o = (k0 + cur) * m;
      store_pair<PIECE>(sums + o, c0, m, s0);
      store_pair<PIECE>(maxs + o, c0, m, x0);
      store_pair<PIECE>(sums + o, c1, m, s1);
      store_pair<PIECE>(maxs + o, c1, m, x1);
    }
    s0 = s1 = zero;
    x0 = x1 = ninf;
    any = false;
  };

  // the ring runs kStages - 1 batches ahead of the one being reduced; a
  // copy group is committed every step, empty or not, so that waiting
  // for all but the newest kStages - 1 groups always means "batch b is in"
  const int nb = (re - rb + kBatch - 1) / kBatch;
  int idx = index_of(0);  // lane rr: the source row of the next batch's row rr
  for (int b = 0; b < kStages - 1; ++b) {
    if (b < nb) {
      fetch(b, idx);
      idx = index_of(b + 1);
    }
    cp_async_commit();
  }
  for (int b = 0; b < nb; ++b) {
    if (b + kStages - 1 < nb) {
      fetch(b + kStages - 1, idx);
      idx = index_of(b + kStages);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* src = ring + (b % kStages) * (kBatch * slot);
    const int base = rb + b * kBatch;
    const int cnt = min(kBatch, re - base);
    for (int rr = 0; rr < cnt; ++rr) {
      while (base + rr >= cur_end) {  // the row opens a later segment
        emit();
        ++cur;
        cur_end = max(cur_end, __shfl_sync(kFull, h, cur + 1));
      }
      const float* row = src + rr * slot;
      if (c0 < m) fold_pair(load_pair<PIECE>(row + c0), s0, x0);
      if (c1 < m) fold_pair(load_pair<PIECE>(row + c1), s1, x1);
      any = true;
    }
    __syncwarp();  // the stage is refilled on a later step
  }
  emit();
}

// Long segments: one block per segment, one thread per column. A
// block streams its segment's rows with four loads in flight per thread,
// and 32 such blocks per SM keep the card's memory busy.
template <bool GATHER>
__global__ void segreduce_long_kernel(const float* __restrict__ rows,
                                      const int* __restrict__ perm,
                                      const int* __restrict__ seg,
                                      const int* __restrict__ first_pos,
                                      float* __restrict__ sums, float* __restrict__ maxs,
                                      int n, int m, int cap) {
  const int k = blockIdx.x;
  const int col = threadIdx.x;
  int beg = __ldg(first_pos + k);
  beg = beg < 0 ? 0 : (beg > n ? n : beg);
  int end = k + 1 < cap ? __ldg(first_pos + k + 1)
                        : warp_upper_bound(seg, beg, n, k, threadIdx.x & 31);
  end = end < beg ? beg : (end > n ? n : end);
  if (beg == end || col >= m) return;  // an absent segment is not written

  float s = 0.0f;
  float mx = -INFINITY;
#pragma unroll 4
  for (int r = beg; r < end; ++r) {
    const long long row = GATHER ? static_cast<long long>(__ldg(perm + r))
                                 : static_cast<long long>(r);
    const float v = __ldg(rows + row * m + col);
    s += v;
    mx = max_nan(mx, v);
  }
  const long long o = static_cast<long long>(k) * m + col;
  sums[o] = s;
  maxs[o] = mx;
}

template <bool GATHER, int PIECE>
int run(const float* rows, const int* perm, const int* seg, const int* first_pos,
        float* sums, float* maxs, int n, int m, int cap, int span, long long blocks,
        size_t smem, cudaStream_t stream) {
  // dynamic shared memory above 48 KB needs the attribute, once per size
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        segreduce_span_kernel<GATHER, PIECE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  segreduce_span_kernel<GATHER, PIECE><<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                                         stream>>>(rows, perm, seg, first_pos, sums, maxs,
                                                   n, m, cap, span);
  return static_cast<int>(cudaGetLastError());
}

template <bool GATHER>
int launch(const float* rows, const int* perm, const int* seg, const int* first_pos,
           float* sums, float* maxs, int n, int m, int cap, void* stream) {
  if (cap <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows_per_seg = n / cap > 1 ? n / cap : 1;
  if (rows_per_seg >= kLongRows) {
    segreduce_long_kernel<GATHER><<<cap, (m + 31) / 32 * 32, 0, s>>>(
        rows, perm, seg, first_pos, sums, maxs, n, m, cap);
    return static_cast<int>(cudaGetLastError());
  }
  int span = kRowsPerWarp / rows_per_seg;
  span = span < 1 ? 1 : (span > kMaxSpan ? kMaxSpan : span);
  const long long warps = (static_cast<long long>(cap) + span - 1) / span;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * kStages * kBatch * slot_floats(m) *
                      sizeof(float);
  if (m % 2 == 0 && reinterpret_cast<uintptr_t>(rows) % 8 == 0)
    return run<GATHER, 8>(rows, perm, seg, first_pos, sums, maxs, n, m, cap, span, blocks,
                          smem, s);
  return run<GATHER, 4>(rows, perm, seg, first_pos, sums, maxs, n, m, cap, span, blocks,
                        smem, s);
}

}  // namespace

extern "C" {

// Fused-gather variant: rows [n_rows, m] f32 in original order, perm [n]
// i32 (values < n_rows), seg [n] i32 ascending, first_pos [cap] i32;
// sums / maxs [cap, m] f32, written for present segments only. Returns
// cudaGetLastError() after the launch.
int segreduce_gather_launch(const float* rows, const int* perm, const int* seg,
                            const int* first_pos, float* sums, float* maxs,
                            int n, int m, int cap, void* stream) {
  return launch<true>(rows, perm, seg, first_pos, sums, maxs, n, m, cap, stream);
}

// Pre-gathered variant: rows [n, m] f32 already in sorted order.
int segreduce_sorted_launch(const float* rows, const int* seg,
                            const int* first_pos, float* sums, float* maxs,
                            int n, int m, int cap, void* stream) {
  return launch<false>(rows, nullptr, seg, first_pos, sums, maxs, n, m, cap, stream);
}

// Every kernel source exports this (kernels/build.py check_launch).
const char* df_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
