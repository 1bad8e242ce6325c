// Fused sketch update over the shared-sorted batch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel deepflow_tpu/ops/sketch_pallas.py:107
// `_fused_kernel` (launcher `sketch_update_fused`, sketch_pallas.py:167).
// Per sorted row i of one sketch-plane phase, with p = s_pos[i] the
// row's position in the unsorted batch:
//   * HLL:   hll[(slot*G + gid[p])*m + reg[p]] = max(., rho[p]) for rows
//            with mask[p];
//   * CMS:   cms[(slot*D + d)*W + col_d] += rw[i] for d < D at run heads
//            (head[i]) with a nonzero run weight;
//   * top-K: per hash row r, the bucket slot*C + col_r keeps the
//            heaviest live run, its first row on ties;
// with slot = s_win[i] mod R.
//
// The TPU kernel is one sequential sweep with the plane state in VMEM.
// Here every row is one thread, and the order-dependent parts become
// order-free atomics:
//   * register max and int32 adds commute (adds wrap in two's
//     complement like XLA's), so HLL and CMS totals are bit-exact in any
//     schedule;
//   * the challenger scan becomes an atomicMax of a 64-bit key
//     ((rw ^ 0x80000000) << 32) | (0xFFFFFFFF - i) into a [d, R*C]
//     table: the high word orders signed run weights, the low word
//     prefers the lower sorted row on ties. The key is nonzero for every
//     live row, so a bucket is "got" exactly when a live row hashed there
//     — the same (got, hw) lanes as the plain version's segment max/min,
//     negative run weights included (hw clamps them to 0).
// Columns are recomputed here from key_hi/key_lo with native uint32
// arithmetic (ops/cms.row_slots, ops/topk.bucket_cols), so the [D, N]
// and [d, N] column planes are never written to memory.
//
// What bounds it on this card: at the main-path shape (2^15 rows, about
// 10,000 live) the function needs about 1.7 MB, half a microsecond of
// HBM time, so a launch's fixed cost and the dependent load chains
// (s_pos -> lane -> atomic) bound it, and the host work of its wrapper
// bounds the call. The design does three things about it:
//   * ONE cooperative launch per call: a grid-stride update, a grid-wide
//     barrier, then a grid-stride resolve that turns each table entry
//     into the (got, hi, lo, ia, ib, hw) challenger lanes of its winning
//     row. The barrier is split: a block arrives once its challenger
//     keys are in, and its HLL and count-min atomics, which the resolve
//     does not read, run while the other blocks arrive. Each live row
//     leaves its ids in a sorted-order scratch before the barrier, so the
//     resolve reads its winner in two rounds of loads, not three.
//   * The per-row lanes are read through the shared sort's s_pos inside
//     the kernel, all gathers of a row in flight together, so the caller
//     writes no sorted copies of them; the slot and the run-head weight
//     are derived here too.
//   * No memset launch: the caller keeps two scratch tables (challenger
//     table + barrier word) per shape and alternates them; each call
//     zeroes the previous call's, done with it in stream order.
//   * Lanes are read at the width they arrive in (int64 u32 lanes).
// What it does not try: banking the touched HLL / CMS cells in shared
// memory. About 10,000 live rows spread over 6.5 MB of state rarely hit
// one cell twice within a block, so global atomics do not bound it here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t cms_col(uint32_t hi, uint32_t lo, uint32_t d,
                                            uint32_t width) {
  uint32_t h = hi + d * lo;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h & (width - 1u);
}

__device__ __forceinline__ uint32_t topk_col(uint32_t hi, uint32_t lo, uint32_t row,
                                             uint32_t cols) {
  uint32_t h = hi + (row + 1u) * lo;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h & (cols - 1u);
}

struct SketchArgs {
  // unsorted batch lanes [n_rows], read through s_pos
  const int64_t* gid;
  const int64_t* reg;
  const int64_t* rho;
  const bool* mask;
  const int64_t* id_a;
  const int64_t* id_b;
  // sorted lanes [n]
  const int64_t* s_pos;
  const int64_t* s_win;
  const bool* head;
  const int* rw;
  const int64_t* s_hi;
  const int64_t* s_lo;
  // state and outputs
  int* hll;
  int* cms;
  unsigned long long* best;   // [d_tk * ring * c_tk + 1], all zero on entry
  unsigned long long* stale;  // the previous call's table: zeroed here
  unsigned long long* ids;    // [n] scratch: id_a | id_b << 32 of live rows
  bool* got;                  // [d_tk, ring * c_tk]
  int* lanes;                 // [d_tk, 5, ring * c_tk]: hi, lo, ia, ib, hw
  int n, ring, g, m, d_cms, w_cms, d_tk, c_tk;
};

// The grid barrier, split so that work the resolve does not read runs
// while the blocks gather: a block arrives (its top-K atomics fenced)
// once every thread of it has sent them, then goes on with the HLL and
// count-min atomics, and waits only before the resolve. A cooperative
// launch keeps every block resident, so the spin cannot starve one.
__device__ __forceinline__ void barrier_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
  }
}

__device__ __forceinline__ void barrier_wait(const unsigned int* count) {
  if (threadIdx.x == 0) {
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < gridDim.x);
  }
  __syncthreads();
}

// What the update needs of one sorted row before the barrier: its
// sorted lanes, then its mask through s_pos.
struct Row {
  long long p;
  uint32_t hi, lo, slot;
  int w;
  bool head, live;
};

__device__ __forceinline__ Row load_row(const SketchArgs& a, int i) {
  Row r;
  r.p = a.s_pos[i];
  r.slot = static_cast<uint32_t>(a.s_win[i]) % static_cast<uint32_t>(a.ring);
  r.hi = static_cast<uint32_t>(a.s_hi[i]);
  r.lo = static_cast<uint32_t>(a.s_lo[i]);
  r.w = a.rw[i];
  r.head = a.head[i];
  r.live = a.mask[r.p];
  return r;
}

__global__ void sketch_fused_kernel(const SketchArgs a) {
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const long long table = static_cast<long long>(a.ring) * a.c_tk;
  const long long buckets = a.d_tk * table;
  // the word after the table counts the blocks that reached the barrier
  unsigned int* count = reinterpret_cast<unsigned int*>(a.best + buckets);

  // update, before the barrier: what the resolve reads — the challenger
  // keys, and each live row's ids in sorted order (gathered with its
  // mask, so the resolve does not go through s_pos again)
  Row first{};
  for (int i = tid; i < a.n; i += stride) {
    const Row r = load_row(a, i);
    const uint32_t ia = static_cast<uint32_t>(a.id_a[r.p]);
    const uint32_t ib = static_cast<uint32_t>(a.id_b[r.p]);
    if (i == tid) first = r;
    if (!r.live) continue;
    a.ids[i] = ia | static_cast<unsigned long long>(ib) << 32;
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<uint32_t>(r.w) ^ 0x80000000u) << 32) |
        static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<uint32_t>(i));
    for (int t = 0; t < a.d_tk; ++t)
      atomicMax(a.best + t * table + r.slot * a.c_tk + topk_col(r.hi, r.lo, t, a.c_tk), key);
  }
  barrier_arrive(count);
  // after it, while the other blocks arrive: HLL and count-min, which
  // nothing in this call reads
  for (int i = tid; i < a.n; i += stride) {
    const Row r = i == tid ? first : load_row(a, i);
    if (r.live)
      atomicMax(a.hll + (static_cast<long long>(r.slot) * a.g + a.gid[r.p]) * a.m + a.reg[r.p],
                static_cast<int>(a.rho[r.p]));
    if (r.head && r.w != 0) {
      for (int d = 0; d < a.d_cms; ++d)
        atomicAdd(a.cms + (static_cast<long long>(r.slot) * a.d_cms + d) * a.w_cms +
                      cms_col(r.hi, r.lo, d, a.w_cms),
                  r.w);
    }
  }
  for (long long j = tid; j <= buckets; j += stride) a.stale[j] = 0ull;
  barrier_wait(count);

  // resolve: each table entry → the (got, hi, lo, ia, ib, hw) lanes of
  // its winning row
  for (long long j = tid; j < buckets; j += stride) {
    const unsigned long long key = __ldcg(a.best + j);
    const long long t = j / table;
    int* out = a.lanes + t * 5 * table + (j - t * table);
    if (key == 0ull) {
      a.got[j] = false;
      out[0] = out[table] = out[2 * table] = out[3 * table] = out[4 * table] = 0;
      continue;
    }
    const int i = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    const int w = static_cast<int>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
    const unsigned long long ids = __ldcg(a.ids + i);
    a.got[j] = true;
    out[0] = static_cast<int>(static_cast<uint32_t>(a.s_hi[i]));
    out[table] = static_cast<int>(static_cast<uint32_t>(a.s_lo[i]));
    out[2 * table] = static_cast<int>(static_cast<uint32_t>(ids));
    out[3 * table] = static_cast<int>(static_cast<uint32_t>(ids >> 32));
    out[4 * table] = w > 0 ? w : 0;
  }
}

constexpr int kThreads = 128;

// Blocks of kThreads that can be resident at once on the current device
// (cached per device): the most a cooperative launch may ask for.
int resident_blocks(int* err) {
  static int cache[64] = {0};
  int dev = 0;
  *err = static_cast<int>(cudaGetDevice(&dev));
  if (*err) return 0;
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  int coop = 0, sms = 0, per_sm = 0;
  *err = static_cast<int>(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!*err) *err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!*err) *err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sketch_fused_kernel, kThreads, 0));
  if (*err) return 0;
  if (!coop || per_sm < 1) {
    *err = static_cast<int>(coop ? cudaErrorCooperativeLaunchTooLarge
                                 : cudaErrorNotSupported);
    return 0;
  }
  const int blocks = sms * per_sm;
  if (dev < 64) cache[dev] = blocks;
  return blocks;
}

}  // namespace

extern "C" {

// Unsorted lanes [n_rows]: gid/reg/rho/id_a/id_b int64 (id lanes u32
// values), mask bool. Sorted lanes [n]: s_pos int64 (position in the
// unsorted batch), s_win/s_hi/s_lo int64 u32 lanes, head bool, rw int32.
// hll [ring*g*m] / cms [ring*d_cms*w_cms] int32 updated in place; best
// [d_tk*ring*c_tk + 1] u64 all zero on entry (the table, then the
// barrier word; left holding this call's winners), stale the same size
// (the previous call's best, left all zero); ids [n] u64 scratch; got
// [d_tk*ring*c_tk] bool and lanes [d_tk, 5, ring*c_tk] int32 written.
// One cooperative launch on `stream`. Returns the first CUDA error, or 0.
int sketch_fused_launch(const int64_t* gid, const int64_t* reg, const int64_t* rho,
                        const bool* mask, const int64_t* id_a, const int64_t* id_b,
                        const int64_t* s_pos, const int64_t* s_win, const bool* head,
                        const int* rw, const int64_t* s_hi, const int64_t* s_lo,
                        int* hll, int* cms, unsigned long long* best,
                        unsigned long long* stale, unsigned long long* ids, bool* got,
                        int* lanes, int n, int ring, int g, int m, int d_cms, int w_cms,
                        int d_tk, int c_tk, void* stream) {
  int err = 0;
  const int resident = resident_blocks(&err);
  if (err) return err;
  SketchArgs a{gid,  reg,  rho, mask, id_a, id_b,  s_pos, s_win, head, rw,
               s_hi, s_lo, hll, cms,  best, stale, ids,   got,   lanes, n,
               ring, g,    m,   d_cms, w_cms, d_tk, c_tk};
  const long long work = n > d_tk * ring * c_tk ? n : static_cast<long long>(d_tk) * ring * c_tk;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > resident) blocks = resident;
  void* params[] = {&a};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sketch_fused_kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  // cudaGetLastError also clears a refused launch, so that no later
  // PyTorch launch check reports it as its own
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

// Every kernel source exports this (kernels/build.py check_launch).
const char* df_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
