// Fused KNN scoring for Hopper: matmul + running top-k, without a
// [Q, cap] score matrix in device memory.
//
// Replaces the TPU kernel pathway_tpu/ops/pallas_knn.py:_knn_kernel. That
// kernel walks the database in blocks on a sequential grid and carries a
// running [Q, k] top-k in VMEM scratch from one grid step to the next.
// Blocks on Hopper run in parallel and carry nothing over, so the work is
// split in two passes:
//
//   fused_knn_partial  grid (query tiles x database splits x parts), about
//                      one CTA per SM at every k, 288 threads: two consumer
//                      warpgroups and one producer warp (warp
//                      specialisation). A CTA answers NQ queries (NQ in
//                      8/16/32/64, a template instance the wrapper picks
//                      from Q) over its range of rows, TM = 128 rows x 32
//                      dims at a time. Where the splits leave SMs idle (a
//                      split is at least 256 rows, so a small index has
//                      few), up to 8 CTAs ("parts") share a split's rows;
//                      each hands its k best to a merge area and the last
//                      to arrive (an atomic count) cuts the parts' lists
//                      to the split's k best, so the output stays
//                      [splits, Q, k]. A CTA ends by sorting each query's
//                      live candidates with all its consumer warps (the
//                      part's end, below). The kernel has two instances
//                      for each tile and precision: k <= 32 (WIDE false),
//                      whose end is one warp's registers, and k > 32.
//     copies           one producer thread keeps cp.async.bulk.tensor (TMA)
//                      loads in flight into a ring of 4-8 shared-memory
//                      stages, each guarded by a full and an empty
//                      mbarrier: the index tile [128 rows][32 dims] and the
//                      queries' hi and lo parts [NQ][32 dims], all in the
//                      128-byte swizzle. Rows past the split end or past
//                      cap and dims past d arrive zero-filled; the epilogue
//                      masks those rows. The queries are split into hi =
//                      tf32(x) and lo = tf32(x - hi) once per launch by a
//                      small pre-pass into a [2, Q, d] scratch copy (L2
//                      resident: the loads ask L2 to keep it, and to evict
//                      the streamed index first), so no stage splits them
//                      again. A stage carries the queries' 32 dims beside
//                      the rows' 32: at d = 384 the hi and lo parts of 64
//                      queries would take 196 KB of shared memory for good.
//     scores           wgmma.mma_async m64nNQk8 .tf32 (3xTF32): index rows
//                      on the M side (64 rows a consumer warpgroup), the
//                      queries on the N side (Q = 1 pads to N = 8, not 64).
//                      A (the index) is read from the stage with ld.shared
//                      and split into hi and lo in registers; B (the
//                      queries' hi and lo tiles) is read by the tensor
//                      cores from shared memory. A stage's 12 wgmmas (lo*hi,
//                      hi*lo and hi*hi of four k-steps, small terms first)
//                      go round-robin to J accumulators (12, 6 or 2 by NQ),
//                      which are added in IEEE fp32 in a fixed order, and
//                      each stage's sum to the score: the tensor cores' own
//                      additions truncate, and short chains keep that
//                      within the accuracy of fp32 (Precision.HIGHEST).
//                      The hardware's own TF32 conversion (truncation) is
//                      never used. At small NQ a wgmma's issue costs about
//                      the same whatever its width, and a stage takes 12:
//                      that, not the bytes, bounds what one CTA streams,
//                      hence a CTA for every SM at every k.
//     one pass         precision "default" (PASSES = 1, the other template
//                      instance): the queries' hi part alone (no lo in the
//                      scratch copy, the ring or the stage), A rounded to
//                      TF32 by tf32_rna, and the four hi*hi wgmmas of a
//                      stage instead of twelve. A product of two TF32
//                      values is exact in fp32, so the instance computes
//                      the fp32 product of the TF32-rounded operands up to
//                      the order of its sums: a unit-vector score within
//                      2^-10 * sum|q_i x_i| of the fp32 one. Selection,
//                      epilogue and the merge are those of PASSES = 3.
//     selection        the epilogue applies the valid mask and the l2sq
//                      form 2s - |q|^2 - |x|^2 and drops every score at or
//                      below its query's running k-th; the rest are
//                      appended, as one 64-bit key (order-preserving value
//                      bits over the inverted slot), to the query's
//                      unsorted candidate buffer of capacity C = k +
//                      max(k, 128) + 128, each at a slot from a shared
//                      atomic (past a split's first tiles a warp keeps a
//                      few scores a tile: warp-wide bookkeeping for them
//                      cost more than the atomics it saved).
//                      When a buffer could not take one more tile, a warp
//                      cuts it to its k best and raises the threshold: for
//                      k <= 32 by k rounds of a warp-wide maximum over the
//                      keys in registers, else by a radix select (a
//                      min/max pass, then 8-bit digits below the keys'
//                      common prefix, finished by sorting the k-th's bin
//                      aside once it is small). At the end a query's n
//                      live survivors (n <= k, fewer where its split had
//                      fewer valid rows) are sorted by (value descending,
//                      slot ascending) and written out, positions n .. k-1
//                      as missing entries: for k <= 32 in one warp's
//                      registers; above, a bitonic network of pow2(n) keys
//                      (not pow2(k)) in registers with every consumer warp
//                      at work (sort_live): a query of up to 1,024 keys is
//                      one warp's, the warps side by side on the CTA's
//                      queries, a larger one the whole CTA's, each warp
//                      sorting its slice before the merges across slices,
//                      in the ring's shared memory (free by then). The
//                      buffers live in shared memory where NQ * C * 8
//                      bytes fit beside a ring of 4 stages, else in a
//                      scratch tensor the wrapper allocates. One selection
//                      serves every k: the register-lane fold of the
//                      mma.sync kernel for k <= 32 is gone, and no shape
//                      keeps the mma.sync kernel.
//   fused_knn_merge    the k best of S runs [S, Q, kp], taken in run order,
//                      in one of two designs (the wrapper picks by size):
//     one CTA          (block) one CTA of 256 threads per query: loads the
//                      runs' S*kp <= 32768 candidates as order-preserving
//                      keys into shared memory, finds the k-th largest by
//                      a radix select (8 bits a pass, at most 4 passes),
//                      keeps every candidate above it and the earliest ones
//                      equal to it, and bitonic-sorts those k by (value
//                      descending, position ascending). Below the
//                      crossover its one launch is the faster.
//     runs             (runs) a merge of sorted runs over many CTAs, for
//                      any S*kp. Precondition: each run is non-increasing
//                      in value (-0 equal to +0), as the partial kernel's
//                      splits, the shards' lists and a tree merge's two
//                      lists all are. The output is cut into segments of
//                      SEG = 256 ranks; two launches of grid (segments x
//                      Q), 256 threads:
//       cut_kernel     for the rank r that ends its segment, the count
//                      c_s(r) that each run gives to the top r (the
//                      co-rank; sum c_s = r). Because a run does not
//                      increase, the r-th key lies between L = min over
//                      runs of key(ceil(r/S) - 1) and U = max of
//                      key(floor((r - 1)/S)); two binary searches a run
//                      cut its window of keys in [L, U] (the keys above U
//                      are all kept, the positions at or past r never),
//                      and a radix select over the windows' keys alone
//                      (held in shared memory; where they do not fit, a
//                      bisection of [L, U] by key, counting the runs'
//                      keys at or above its midpoint, narrows them first,
//                      else they are read again from L2 each pass),
//                      starting at the highest bit in which L and U
//                      differ, finds the r-th key.
//                      Binary searches inside the windows then count each
//                      run's keys above it and equal to it; the equal
//                      ones are given to the lowest runs first.
//       place_kernel   the segment's entries are positions
//                      [c_s(r0), c_s(r1)) of each run: at most 256, loaded
//                      once, each placed at r0 plus its rank among them by
//                      (key, then run, then position), counted against the
//                      others in shared memory. No sort of k in one CTA.
//                      The candidates stay in device memory (L2); a query's
//                      work is a few binary searches a run and its window,
//                      not its S*kp candidates.
//
// Output contract (that of _knn_kernel): values in descending order; equal
// values ordered by lower slot first; a missing entry is -inf with a slot
// in range. Within a split the tie rule holds by slot, not by scan order:
// the candidate keys order equal values by slot, the selects keep the
// lower slots, and the final sort orders by (value, slot); a score equal
// to the running k-th is dropped, which is right because every row met
// later has a higher slot than every candidate. Splits cover ascending
// slot ranges and the merge breaks ties by position in split order. Every
// row of every split goes through the same wgmma sequence in the same
// order of dims, so equal rows score bit-equally.
//
// Bound on an H100 SXM: the database read, 4*cap*d bytes at 3.35 TB/s
// (0.48 ms at cap=2^20, d=384), or, when Q is large, the lesser of the
// 2*Q*cap*d FP32 operations at 67 TFLOP/s and the 3 x 2*Q*cap*d TF32
// operations at 495 TFLOP/s (1.25 ms at Q=256); with one pass, the
// 2*Q*cap*d TF32 operations (0.42 ms at Q=256, under the read).
//
// Bound of the merge: its inputs' kept entries read once and the [Q, k]
// pair written once, 16*Q*k bytes at 3.35 TB/s. Its time is latency: a
// chain of dependent L2 reads (the searches) a CTA.
//
// Limits: 1 <= k <= 8192, d % 4 == 0, 16-byte aligned rows, PASSES in
// {1, 3}; the one-CTA merge S*kp <= 32768 candidates, the run merge
// S <= 8192 runs and S*kp < 2^31.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;           // index rows per tile: 64 per consumer warpgroup
constexpr int DK = 32;            // dims per stage: 128 bytes, one swizzle row
constexpr int ROW_BYTES = DK * 4;
constexpr int THREADS = 288;      // two consumer warpgroups, one producer warp
constexpr int CONSUMERS = 256;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int SELECT_ROOM = 4096;  // shared bytes a consumer warp's selects use
constexpr int SELECT_SIDE = SELECT_ROOM / 8;  // keys of the k-th's bin sorted aside
constexpr int SMALL_KEYS = 9;     // keys a lane holds in a select for k <= 32: capacity(32) / 32
constexpr int MIN_STAGES = 4;
constexpr int MAX_STAGES = 8;
constexpr int MAX_PARTS = 8;      // CTAs that share a split
constexpr int K_MAX = 8192;
constexpr int ROW_GRANULE = 256;  // rows per split are a multiple of this
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_MAX = 32768;  // candidates a query the one-CTA merge holds
constexpr int SEG = MERGE_THREADS;  // ranks a run-merge CTA places: one a thread
constexpr int RUNS_MAX = 8192;    // runs the run merge takes (shared counts a run)
constexpr int WINDOW_KEYS = 16384;  // window keys a cut keeps in shared memory
constexpr int SMEM_MAX = 232448;  // 227 KB a block may use
constexpr unsigned FULL = 0xffffffffu;

// candidates a query's buffer holds: the k best, slack for about k more
// (so that a select runs about once per doubling of the rows seen), and
// one tile's rows
int capacity(int k) { return (k + (k > TM ? k : TM) + TM + 31) / 32 * 32; }

// query parts a stage carries: hi and lo for 3xTF32, hi alone for one pass
__host__ __device__ constexpr int query_parts(int passes) { return passes == 3 ? 2 : 1; }

size_t stage_bytes(int nq, int passes) {
  return (size_t)(TM + query_parts(passes) * nq) * ROW_BYTES;
}

// 1 KB to align the ring, the ring, the mbarriers, |q|^2, the running
// thresholds and counts, each consumer warp's room for its selects (a
// radix histogram, then the keys it sorts aside), and the candidate
// buffers when they live in shared memory
size_t partial_smem_bytes(int nq, int stages, int k, bool smem_buffers, int passes) {
  return 1024 + (size_t)stages * stage_bytes(nq, passes) + 16 * MAX_STAGES + 12 * (size_t)nq +
         (size_t)CONSUMER_WARPS * SELECT_ROOM +
         (smem_buffers ? (size_t)8 * nq * capacity(k) : 0);
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed
// (a phase that never completes traps after about ten seconds: a launch
// error, not a hung card)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}
// L2 policies: the index streams through once (evict first), so that it
// does not push the candidate buffers and the split queries out of L2
// (evict last)
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0),
      "r"(c1), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void named_bar_sync() {  // the consumer warpgroups only
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving a register's uses across a wgmma wait
template <int M> __device__ __forceinline__ void fence_regs(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); a k-step of 8 dims
// advances the start address by 32 bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// x = hi + lo, each rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: cvt.rna) by integer ops, which issue at the ALU rate; the
// conversion unit's cvt.rna.tf32 issues at a fraction of it
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));  // x - hi is exact
}

// order-preserving key: a larger float gives a larger key; -0 counts as +0
__device__ __forceinline__ uint32_t fkey(float v) {
  if (v == 0.f) v = 0.f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float fvalue(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// wgmma m64nNk8 .f32.tf32.tf32, A (4 registers a thread) from registers, B
// from shared memory; d += A*B, or d = A*B when scale_d is 0
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// the queries' TF32 parts: hi and lo for 3xTF32, hi alone for one pass
template <int PASSES>
__global__ void split_kernel(const float* __restrict__ q, float* __restrict__ qs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t hi, lo;
    split_tf32(q[i], hi, lo);
    qs[i] = __uint_as_float(hi);
    if constexpr (PASSES == 3) qs[n + i] = __uint_as_float(lo);
  }
}

// The same for k <= 32 and n <= 32 * SMALL_KEYS (every buffer of such a k,
// and a merge of its parts): the keys held in registers, k rounds of a
// warp-wide maximum, each winner dropped by the lane that holds it (keys
// are distinct); b[0..k) gets them in descending order
__device__ __noinline__ float warp_select_small(unsigned long long* b, int n, int k, int lane) {
  unsigned long long x[SMALL_KEYS];
#pragma unroll
  for (int r = 0; r < SMALL_KEYS; ++r) {
    const int i = 32 * r + lane;
    x[r] = i < n ? b[i] : 0ull;
  }
  __syncwarp();
  unsigned long long best = 0ull;
  for (int j = 0; j < k; ++j) {
    best = 0ull;
#pragma unroll
    for (int r = 0; r < SMALL_KEYS; ++r) best = x[r] > best ? x[r] : best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, best, off);
      best = o > best ? o : best;
    }
#pragma unroll
    for (int r = 0; r < SMALL_KEYS; ++r) x[r] = x[r] == best ? 0ull : x[r];
    if (lane == 0) b[j] = best;
  }
  __syncwarp();
  return fvalue((uint32_t)(best >> 32));
}

// The k best of a query's candidate buffer b[0..n), n > k, by one warp:
// radix select of the k-th largest key, then an in-place compaction to the
// k keys at or above it. A first pass finds the least and the largest key:
// the bits they share are every key's, so the first digit (8 bits) starts
// at the highest bit in which they differ, and the keys spread over its
// bins instead of piling into one; each later digit counts only the keys
// of the chosen bin. It stops once every key of that bin is needed, or once
// the bin is small: then one pass moves the keys above it to the front and
// sorts the bin's keys aside. Typically three passes in all. Returns the
// new threshold, the k-th best value.
// `hist` is the warp's room in shared memory. The select is kept out of
// line (it runs a few times a split): inlined at its call sites it made the
// kernel's per-tile loop slower, and reaching the room through the dynamic
// shared array instead of a pointer did too, though its atomics then stay
// shared ones rather than generic.
__device__ __noinline__ float warp_select(unsigned long long* b, int n, int k, uint32_t* hist,
                                         int lane) {
  if (k <= 32 && n <= 32 * SMALL_KEYS) return warp_select_small(b, n, k, lane);
  unsigned long long lo = ~0ull, hi = 0ull;
  // sixteen keys in flight a lane: the buffer may lie in device memory
  for (int base = 0; base < n; base += 512) {
    unsigned long long u[16];
#pragma unroll
    for (int h = 0; h < 16; ++h) {
      const int i = base + 32 * h + lane;
      u[h] = i < n ? b[i] : 0ull;
    }
#pragma unroll
    for (int h = 0; h < 16; ++h)
      if (base + 32 * h + lane < n) {
        lo = u[h] < lo ? u[h] : lo;
        hi = u[h] > hi ? u[h] : hi;
      }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long l = __shfl_xor_sync(FULL, lo, off), h = __shfl_xor_sync(FULL, hi, off);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
  }
  int top = 63 - __clzll((long long)(lo ^ hi));  // the keys are distinct: lo != hi
  unsigned long long mask = top == 63 ? 0ull : ~0ull << (top + 1);
  unsigned long long prefix = lo & mask;
  int need = k;
  while (true) {
    const int shift = top > 7 ? top - 7 : 0;
    const uint32_t digit = (1u << (top - shift + 1)) - 1;
    for (int j = lane; j < 256; j += 32) hist[j] = 0;
    __syncwarp();
    for (int base = 0; base < n; base += 512) {
      unsigned long long u[16];
#pragma unroll
      for (int h = 0; h < 16; ++h) {
        const int i = base + 32 * h + lane;
        u[h] = i < n ? b[i] : 0ull;
      }
#pragma unroll
      for (int h = 0; h < 16; ++h)
        if (base + 32 * h + lane < n && (u[h] & mask) == prefix)
          atomicAdd(&hist[(uint32_t)(u[h] >> shift) & digit], 1u);
    }
    __syncwarp();
    // lane l sums bins 255-8l .. 248-8l (top first)
    int cnt[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) { cnt[j] = (int)hist[255 - 8 * lane - j]; sum += cnt[j]; }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    const int owner = __ffs(__ballot_sync(FULL, incl >= need)) - 1;
    int above = incl - sum, bin = 255 - 8 * lane - 7, in_bin = cnt[7];
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!found) {
        if (above + cnt[j] >= need) { found = true; bin = 255 - 8 * lane - j; in_bin = cnt[j]; }
        else above += cnt[j];
      }
    }
    bin = __shfl_sync(FULL, bin, owner);
    above = __shfl_sync(FULL, above, owner);
    in_bin = __shfl_sync(FULL, in_bin, owner);
    prefix |= (unsigned long long)bin << shift;
    mask |= (unsigned long long)digit << shift;
    need -= above;
    top = shift - 1;
    __syncwarp();  // every lane has read the counts before the histogram is reused
    if (in_bin == need || top < 0) break;  // the whole bin is kept
    if (in_bin <= SELECT_SIDE) {
      // one pass ends it: the keys above the bin go to the front, the bin's
      // keys aside (into the warp's room, over the histogram), where a
      // bitonic sort finds the `need` best of them
      unsigned long long* side = reinterpret_cast<unsigned long long*>(hist);
      int w = 0, m = 0;
      for (int base = 0; base < n; base += 128) {
        unsigned long long u[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int i = base + 32 * h + lane;
          u[h] = i < n ? b[i] : 0ull;
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const bool in = base + 32 * h + lane < n;
          const bool up = in && (u[h] & mask) > prefix, mem = in && (u[h] & mask) == prefix;
          const unsigned bu = __ballot_sync(FULL, up), bm = __ballot_sync(FULL, mem);
          if (up) b[w + __popc(bu & ((1u << lane) - 1))] = u[h];
          if (mem) side[m + __popc(bm & ((1u << lane) - 1))] = u[h];
          w += __popc(bu);
          m += __popc(bm);
        }
      }
      int p = 32;
      while (p < m) p <<= 1;
      for (int i = m + lane; i < p; i += 32) side[i] = 0ull;
      __syncwarp();
      for (int size = 2; size <= p; size <<= 1)
        for (int st = size >> 1; st > 0; st >>= 1) {
          for (int i = lane; i < p / 2; i += 32) {
            const int lo = 2 * i - (i & (st - 1)), hi = lo + st;
            const unsigned long long x = side[lo], y = side[hi];
            if ((x < y) == ((lo & size) == 0)) { side[lo] = y; side[hi] = x; }
          }
          __syncwarp();
        }
      for (int i = lane; i < need; i += 32) b[w + i] = side[i];
      const unsigned long long kth = side[need - 1];
      __syncwarp();
      return fvalue((uint32_t)(kth >> 32));
    }
  }
  // keep the keys above the k-th's bin and the whole bin: exactly k
  int w = 0;
  uint32_t low = FULL;
  for (int base = 0; base < n; base += 128) {
    unsigned long long u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int i = base + 32 * h + lane;
      u[h] = i < n ? b[i] : 0ull;
    }
    // every lane has read its keys: writes land at or below the read
    // positions, never on a key not yet read
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const bool keep = base + 32 * h + lane < n && (u[h] & mask) >= prefix;
      const unsigned bal = __ballot_sync(FULL, keep);
      if (keep) {
        b[w + __popc(bal & ((1u << lane) - 1))] = u[h];
        low = min(low, (uint32_t)(u[h] >> 32));
      }
      w += __popc(bal);
    }
  }
  for (int off = 16; off > 0; off >>= 1) low = min(low, __shfl_xor_sync(FULL, low, off));
  __syncwarp();
  return fvalue(low);
}

// The real keys of b[0..n) (those at or above 2^32: below are missing
// entries) moved to its front in order, by one warp; returns their count.
// Writes land at or below the positions read, on keys every lane has read
// (as in warp_select's last pass).
__device__ __forceinline__ int warp_compact(unsigned long long* b, int n, int lane) {
  int w = 0;
  for (int base = 0; base < n; base += 128) {
    unsigned long long u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int i = base + 32 * h + lane;
      u[h] = i < n ? b[i] : 0ull;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const bool real = (u[h] >> 32) != 0;
      const unsigned bal = __ballot_sync(FULL, real);
      if (real) b[w + __popc(bal & ((1u << lane) - 1))] = u[h];
      w += __popc(bal);
    }
  }
  __syncwarp();
  return w;
}

// -- the part's end for k > 32: each query's live keys sorted ----------------
//
// A query's n <= k live keys (every real key is distinct: its slot is in
// the low bits) are sorted by a bitonic network of pow2(n) keys, zeros
// padding it (they sort last), and written as its answer, positions n ..
// k-1 missing. Keys sit in registers, E a thread, thread t holding
// positions t*E .. t*E + E-1 ("blocked"): strides below E are exchanges
// in a thread's registers, strides below 32 E shuffles between lanes.
// A query of at most WARP_SORT_MAX keys is one warp's (E <= 32), the warps
// side by side on the CTA's queries; a larger one the whole CTA's (E =
// pow2(n) / 256), one query after another: each warp sorts its slice of 32
// E keys, then each merge across slices takes its strides of 32 E and
// more in a transposed layout (thread t holding positions w*32E + 256m + t
// of the eight slices w, m < E/8: those strides too are in its registers)
// and the rest back in the blocked one. Layouts change through shared
// memory (the ring, free now), padded so that both the blocked and the
// coalesced accesses are free of bank conflicts.

constexpr int WARP_SORT_MAX = 1024;  // live keys one warp sorts: 32 a lane
constexpr int WARP_AREA = WARP_SORT_MAX + WARP_SORT_MAX / 32;  // its padded keys
// shared bytes the sort uses, at the ring's start: eight warps' areas, or
// the CTA's area of 8192 keys (as many)
constexpr int SORT_BYTES = 8 * CONSUMER_WARPS * WARP_AREA;

// shared bytes of the part's end for k: none where one warp's registers
// hold the k best (k <= 32)
int sort_bytes(int k) { return k > 32 ? SORT_BYTES : 0; }

// position of key i in a sort area of E keys a thread (E >= 16: one pad a
// thread's E keys; else one a 16)
template <int E> __device__ __forceinline__ int spot(int i) { return i + (i >> (E >= 32 ? 5 : 4)); }

// the keys at positions i < j: descending puts the larger at i
__device__ __forceinline__ void cex(unsigned long long& a, unsigned long long& b, bool desc) {
  const unsigned long long x = a, y = b;
  const bool swap = (x < y) == desc;
  a = swap ? y : x;
  b = swap ? x : y;
}

// the strides below min(E, size) of a bitonic merge of blocks of `size`
// (a block is descending where (position & size) == 0): in registers
template <int E>
__device__ __forceinline__ void thread_steps(unsigned long long (&x)[E], int base, int size) {
#pragma unroll
  for (int st = E / 2; st > 0; st >>= 1)
    if (st < size) {
#pragma unroll
      for (int r = 0; r < E; ++r)
        if (!(r & st)) cex(x[r], x[r | st], ((base | r) & size) == 0);
    }
}

// one stride E <= st < 32 E: lanes st / E apart exchange keys
template <int E>
__device__ __forceinline__ void lane_step(unsigned long long (&x)[E], int base, int size, int st,
                                          int lane) {
  const int m = st / E;
  // a thread's keys share their block's direction: size > st >= E
  const bool take_max = ((lane & m) == 0) == ((base & size) == 0);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const unsigned long long y = __shfl_xor_sync(FULL, x[r], m);
    x[r] = ((x[r] < y) == take_max) ? y : x[r];
  }
}

// the strides below 32 E of a merge of blocks of `size`
template <int E>
__device__ __forceinline__ void warp_merge(unsigned long long (&x)[E], int base, int size, int lane) {
  for (int st = min(size / 2, 16 * E); st >= E; st >>= 1) lane_step<E>(x, base, size, st, lane);
  thread_steps<E>(x, base, size);
}

// each warp's 32 E keys sorted, alternately descending and ascending by
// position (the whole run descending when it is one warp's)
template <int E>
__device__ __forceinline__ void warp_sort(unsigned long long (&x)[E], int base, int lane) {
  for (int size = 2; size <= 32 * E; size <<= 1) warp_merge<E>(x, base, size, lane);
}

// answer position j from key x (0: a missing entry, -inf at slot 0)
__device__ __forceinline__ void put(float* v, int* s, int j, unsigned long long x) {
  const bool real = (x >> 32) != 0;
  v[j] = real ? fvalue((uint32_t)(x >> 32)) : -CUDART_INF_F;
  s[j] = real ? (int)(0xffffffffu - (uint32_t)x) : 0;
}

// src[0..n), n <= 32 E, sorted by one warp in `area` (its own, 32 E
// padded keys) and written to v, s [k]
template <int E>
__device__ __forceinline__ void warp_sort_write(const unsigned long long* src, int n, int k,
                                                unsigned long long* area, float* v, int* s,
                                                int lane) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = 32 * j + lane;
    area[spot<E>(i)] = i < n ? src[i] : 0ull;
  }
  __syncwarp();
  const int base = lane * E;
  unsigned long long x[E];
#pragma unroll
  for (int r = 0; r < E; ++r) x[r] = area[spot<E>(base + r)];
  warp_sort<E>(x, base, lane);
  // a lane writes back the positions it read: no other lane's
#pragma unroll
  for (int r = 0; r < E; ++r) area[spot<E>(base + r)] = x[r];
  __syncwarp();
  for (int j = lane; j < k; j += 32) put(v, s, j, j < n ? area[spot<E>(j)] : 0ull);
  __syncwarp();
}

// src[0..n), 32 E < n <= 256 E, sorted by the 256 consumer threads in
// `area` (256 E padded keys) and written to v, s [k]
template <int E>
__device__ __forceinline__ void cta_sort_write(const unsigned long long* src, int n, int k,
                                               unsigned long long* area, float* v, int* s,
                                               int tid, int lane) {
  constexpr int S = 32 * E, P = 256 * E;  // a warp's slice, the network
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = CONSUMERS * j + tid;
    area[spot<E>(i)] = i < n ? src[i] : 0ull;
  }
  named_bar_sync();
  const int base = tid * E;
  unsigned long long x[E];
#pragma unroll
  for (int r = 0; r < E; ++r) x[r] = area[spot<E>(base + r)];
  warp_sort<E>(x, base, lane);
  for (int size = 2 * S; size <= P; size <<= 1) {
    // a thread stores and loads the positions it loaded and stored last:
    // one barrier a change of layout
#pragma unroll
    for (int r = 0; r < E; ++r) area[spot<E>(base + r)] = x[r];
    named_bar_sync();
#pragma unroll
    for (int m = 0; m < E / 8; ++m)
#pragma unroll
      for (int w = 0; w < 8; ++w) x[8 * m + w] = area[spot<E>(w * S + CONSUMERS * m + tid)];
    // strides S << b: register w against w | 1 << b; a slice's positions
    // share their block's direction (size >= 2 S)
#pragma unroll
    for (int b = 2; b >= 0; --b)
      if ((S << b) < size) {
#pragma unroll
        for (int m = 0; m < E / 8; ++m)
#pragma unroll
          for (int w = 0; w < 8; ++w)
            if (!(w & (1 << b)))
              cex(x[8 * m + w], x[8 * m + (w | (1 << b))], ((w * S) & size) == 0);
      }
#pragma unroll
    for (int m = 0; m < E / 8; ++m)
#pragma unroll
      for (int w = 0; w < 8; ++w) area[spot<E>(w * S + CONSUMERS * m + tid)] = x[8 * m + w];
    named_bar_sync();
#pragma unroll
    for (int r = 0; r < E; ++r) x[r] = area[spot<E>(base + r)];
    warp_merge<E>(x, base, size, lane);
  }
#pragma unroll
  for (int r = 0; r < E; ++r) area[spot<E>(base + r)] = x[r];
  named_bar_sync();
  for (int j = tid; j < k; j += CONSUMERS) put(v, s, j, j < n ? area[spot<E>(j)] : 0ull);
}

// The part's end for k > 32, by the 256 consumer threads: query ql's
// cnt[ql] live keys (keys + ql * stride) sorted and written to out_v,
// out_i + ql * k. With `gather` (CTAs shared the split) the keys are the
// last part's cut of the parts' lists: k of them, its missing entries
// small keys among the real ones, which are counted and moved to the
// front first (into cnt). Kept out of line, as warp_select is, so that the
// kernel's per-tile loop is compiled as it was without it; it reaches the
// ring through the dynamic shared array, so that its accesses are shared
// ones.
__device__ __noinline__ void sort_live(unsigned long long* keys, size_t stride, int* cnt,
                                       int q_live, int k, bool gather, float* out_v,
                                       int* out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* ring = reinterpret_cast<unsigned long long*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (gather) {
    for (int ql = warp; ql < q_live; ql += CONSUMER_WARPS) {
      const int live = warp_compact(keys + ql * stride, k, lane);
      if (lane == 0) cnt[ql] = live;
    }
    named_bar_sync();
  }
  unsigned long long* mine = ring + warp * WARP_AREA;
  for (int ql = warp; ql < q_live; ql += CONSUMER_WARPS) {
    const int n = cnt[ql];
    if (n > WARP_SORT_MAX) continue;
    const unsigned long long* src = keys + ql * stride;
    float* v = out_v + (size_t)ql * k;
    int* s = out_i + (size_t)ql * k;
    if (n <= 32) warp_sort_write<1>(src, n, k, mine, v, s, lane);
    else if (n <= 64) warp_sort_write<2>(src, n, k, mine, v, s, lane);
    else if (n <= 128) warp_sort_write<4>(src, n, k, mine, v, s, lane);
    else if (n <= 256) warp_sort_write<8>(src, n, k, mine, v, s, lane);
    else if (n <= 512) warp_sort_write<16>(src, n, k, mine, v, s, lane);
    else warp_sort_write<32>(src, n, k, mine, v, s, lane);
  }
  for (int ql = 0; ql < q_live; ++ql) {
    const int n = cnt[ql];
    if (n <= WARP_SORT_MAX) continue;
    named_bar_sync();  // the area is free: the warps' sorts, the last query's writes are done
    const unsigned long long* src = keys + ql * stride;
    float* v = out_v + (size_t)ql * k;
    int* s = out_i + (size_t)ql * k;
    if (n <= 2048) cta_sort_write<8>(src, n, k, ring, v, s, tid, lane);
    else if (n <= 4096) cta_sort_write<16>(src, n, k, ring, v, s, tid, lane);
    else cta_sort_write<32>(src, n, k, ring, v, s, tid, lane);
  }
}

template <int NQ, int PASSES, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
partial_kernel(const __grid_constant__ CUtensorMap db_map, const __grid_constant__ CUtensorMap q_map,
               const float* __restrict__ q, const unsigned char* __restrict__ valid,
               const float* __restrict__ sq, int Q, int N, int D, int k, int l2sq,
               int rows_per_split, int parts, int stages, int cap,
               unsigned long long* __restrict__ gbuf, unsigned long long* __restrict__ mbuf,
               int* __restrict__ arrived, float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int M = NQ / 2;  // accumulator registers a thread: 64 rows x NQ / 128
  // independent accumulator sets a stage: as many as fit beside the score
  // and the A fragments
  // (a stage issues 3 * 4 wgmmas with three passes, 4 with one)
  constexpr int J3 = NQ <= 16 ? 12 : (NQ == 32 ? 6 : 2);
  constexpr int J = PASSES == 3 ? J3 : (J3 < 4 ? J3 : 4);
  constexpr uint32_t STAGE = (TM + query_parts(PASSES) * NQ) * ROW_BYTES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // aligned to 1 KB (the 128-byte swizzle's atom) by pointer arithmetic, not
  // through an integer, so that every pointer below stays a shared-memory
  // one: its loads, stores and atomics are ld/st/atom.shared, not generic
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * STAGE);  // full, empty
  float* qn = reinterpret_cast<float*>(bars + 2 * MAX_STAGES);                  // [NQ] |q|^2
  float* thr = qn + NQ;                                  // [NQ] running k-th
  int* cnt = reinterpret_cast<int*>(thr + NQ);           // [NQ] buffer fill
  unsigned char* room = reinterpret_cast<unsigned char*>(cnt + NQ);  // [8][SELECT_ROOM]
  unsigned long long* sbuf =
      reinterpret_cast<unsigned long long*>(room + CONSUMER_WARPS * SELECT_ROOM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_base = blockIdx.x * NQ;
  const int q_live = min(NQ, Q - q_base);  // queries this CTA answers
  // a split's rows are shared by `parts` CTAs, whole tiles each
  const int split = blockIdx.y / parts, part = blockIdx.y % parts;
  const int part_rows = (rows_per_split + parts * TM - 1) / (parts * TM) * TM;
  const int split_end = min(N, (split + 1) * rows_per_split);
  const int row_begin = min(split_end, split * rows_per_split + part * part_rows);
  const int row_end = min(split_end, row_begin + part_rows);
  const int nd = (D + DK - 1) / DK;
  const uint32_t ring_s = smem_u32(ring), bars_s = smem_u32(bars);
  auto full_bar = [&](int s) { return bars_s + 8 * s; };
  auto empty_bar = [&](int s) { return bars_s + 8 * (MAX_STAGES + s); };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int i = tid; i < NQ; i += THREADS) { thr[i] = -CUDART_INF_F; cnt[i] = 0; }
  for (int ql = warp; ql < NQ; ql += THREADS / 32) {
    float acc = 0.f;
    if (l2sq && ql < q_live)
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)(q_base + ql) * D + d];
        acc = fmaf(v, v, acc);
      }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) qn[ql] = acc;
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // -- producer warp: one thread keeps the ring full ---------------------
    if (lane == 0) {
      int s = 0;
      uint32_t par = 0;
      const int total = (row_end - row_begin + TM - 1) / TM * nd;
      const uint64_t stream_policy = l2_evict_first(), keep_policy = l2_evict_last();
      for (int c = 0; c < total; ++c) {
        mbar_wait(empty_bar(s), par ^ 1);  // a fresh barrier passes parity 1
        mbar_expect_tx(full_bar(s), STAGE);
        const int d0 = (c % nd) * DK, row0 = row_begin + (c / nd) * TM;
        const uint32_t dst = ring_s + s * STAGE;
        tma_load_2d(dst, &db_map, d0, row0, full_bar(s), stream_policy);
        tma_load_3d(dst + TM * ROW_BYTES, &q_map, d0, q_base, 0, full_bar(s), keep_policy);
        if constexpr (PASSES == 3)
          tma_load_3d(dst + (TM + NQ) * ROW_BYTES, &q_map, d0, q_base, 1, full_bar(s), keep_policy);
        if (++s == stages) { s = 0; par ^= 1; }
      }
    }
    return;
  }

  // -- consumer warpgroups: scores, epilogue, selection -------------------
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int row_in_tile = 64 * wg + 16 * (warp & 3) + g;  // and +8; row & 7 == g
  unsigned long long* buf =
      gbuf ? gbuf + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * NQ * cap : sbuf;
  uint32_t* my_room = reinterpret_cast<uint32_t*>(room + warp * SELECT_ROOM);

  int s = 0;
  uint32_t par = 0;
  // one stage into tt: its 12 wgmmas (lo*hi, hi*lo, hi*hi of each of four
  // k-steps; with one pass the 4 hi*hi alone) go round-robin to J
  // accumulators, each a short chain of the tensor cores' truncating
  // additions; the J sums are added in IEEE fp32 in a fixed order, the
  // same for every row
  auto stage_scores = [&](float (&tt)[M]) {
    mbar_wait(full_bar(s), par);
    const unsigned char* stage = ring + s * STAGE;
    // A fragments (rows g and g+8, dims t and t+4 of each k-step) from the
    // swizzled tile: 16-byte chunk j of row r sits at chunk j ^ (r & 7)
    uint32_t ah[4][4], al[4][4];
    const unsigned char* arow = stage + row_in_tile * ROW_BYTES + 4 * t;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c0 = ((2 * ks) ^ g) << 4, c1 = ((2 * ks + 1) ^ g) << 4;
      const float* x[4] = {reinterpret_cast<const float*>(arow + c0),
                           reinterpret_cast<const float*>(arow + 8 * ROW_BYTES + c0),
                           reinterpret_cast<const float*>(arow + c1),
                           reinterpret_cast<const float*>(arow + 8 * ROW_BYTES + c1)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (PASSES == 3) split_tf32(*x[i], ah[ks][i], al[ks][i]);
        else ah[ks][i] = tf32_rna(__float_as_uint(*x[i]));
      }
    }
    const uint64_t bh = smem_desc(smem_u32(stage + TM * ROW_BYTES));
    float sums[J][M];
#pragma unroll
    for (int j = 0; j < J; ++j) fence_regs(sums[j]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (PASSES == 3) {
        const uint64_t bl = smem_desc(smem_u32(stage + (TM + NQ) * ROW_BYTES));
        const int w = 3 * ks;  // small terms first
        Wgmma<NQ>::mma(sums[w % J], al[ks], bh + 2 * ks, w >= J);
        Wgmma<NQ>::mma(sums[(w + 1) % J], ah[ks], bl + 2 * ks, w + 1 >= J);
        Wgmma<NQ>::mma(sums[(w + 2) % J], ah[ks], bh + 2 * ks, w + 2 >= J);
      } else {
        Wgmma<NQ>::mma(sums[ks % J], ah[ks], bh + 2 * ks, ks >= J);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < J; ++j) fence_regs(sums[j]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(s));
    if (++s == stages) { s = 0; par ^= 1; }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float v = sums[0][i];
#pragma unroll
      for (int j = 1; j < J; ++j) v += sums[j][i];
      tt[i] = v;
    }
  };

  const int tiles = (row_end - row_begin + TM - 1) / TM;
  for (int ti = 0; ti < tiles; ++ti) {
    const int tile = row_begin + ti * TM;
    // the tile's validity and norms, read in its epilogue
    bool ok[2];
    float rsq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tile + row_in_tile + 8 * h;
      ok[h] = row < row_end && valid[row];
      rsq[h] = (ok[h] && l2sq) ? sq[row] : 0.f;
    }
    // the first stage's sum is the score; each later one is added to it
    float acc[M];
    stage_scores(acc);
    for (int ch = 1; ch < nd; ++ch) {
      float tt[M];
      stage_scores(tt);
#pragma unroll
      for (int i = 0; i < M; ++i) acc[i] += tt[i];
    }

    // epilogue: mask, l2sq form, threshold filter -> candidate buffers.
    // A thread holds M / 2 columns (queries) in two rows: their thresholds
    // and norms are read once, every test is made before any append
    named_bar_sync();  // the last tile's selects are done
    float th[M / 2], qq[M / 2];
#pragma unroll
    for (int c = 0; c < M / 2; ++c) {
      const int col = 8 * (c >> 1) + 2 * t + (c & 1);
      th[c] = thr[col];
      qq[c] = l2sq ? qn[col] : 0.f;
    }
    bool keep[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int c = 2 * (i >> 2) + (i & 1), h = (i >> 1) & 1;
      if (l2sq) acc[i] = 2.f * acc[i] - qq[c] - rsq[h];
      keep[i] = ok[h] && 8 * (i >> 2) + 2 * t + (i & 1) < q_live && acc[i] > th[c];
    }
    // appends: past a split's first tiles a warp keeps a few scores a tile,
    // so each takes its own slot with a shared atomic, and a thread that
    // keeps none does no more than its tests
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (keep[i]) {
        const int col = 8 * (i >> 2) + 2 * t + (i & 1), h = (i >> 1) & 1;
        const int pos = atomicAdd(&cnt[col], 1);
        buf[(size_t)col * cap + pos] = ((unsigned long long)fkey(acc[i]) << 32) |
                                       (0xffffffffu - (uint32_t)(tile + row_in_tile + 8 * h));
      }
    named_bar_sync();  // every append is in (bar.sync orders memory for the CTA)
    // a buffer that could not take another tile is cut to its k best
    for (int ql = warp; ql < q_live; ql += CONSUMER_WARPS) {
      const int n = cnt[ql];
      if (n > cap - TM) {
        const float kth = warp_select(buf + (size_t)ql * cap, n, k, my_room, lane);
        if (lane == 0) { thr[ql] = kth; cnt[ql] = k; }
      }
    }
  }

  // -- the part's end ------------------------------------------------------
  named_bar_sync();
  for (int ql = warp; ql < q_live; ql += CONSUMER_WARPS) {
    const int n = cnt[ql];
    if (n > k) {
      warp_select(buf + (size_t)ql * cap, n, k, my_room, lane);
      if (lane == 0) cnt[ql] = k;
    }
  }
  named_bar_sync();
  // keys of query ql to sort and write: stride apart, k of them (keys below
  // 2^32 are missing entries: every real key is above 2^55)
  unsigned long long* keys = buf;
  size_t stride = cap;
  if (parts > 1) {
    // the parts of a split hand their k best to its merge area; the last to
    // arrive cuts the parts' lists to the split's k best
    const int group = split * gridDim.x + blockIdx.x;
    keys = mbuf + (size_t)group * NQ * parts * k;
    stride = (size_t)parts * k;
    for (int ql = warp; ql < q_live; ql += CONSUMER_WARPS) {
      const int n = cnt[ql];
      unsigned long long* dst = keys + ql * stride + (size_t)part * k;
      // a missing entry is a distinct small key, so that no two tie
      for (int j = lane; j < k; j += 32)
        dst[j] = j < n ? buf[(size_t)ql * cap + j] : (unsigned long long)(part * k + j);
    }
    __threadfence();
    named_bar_sync();
    if (tid == 0) cnt[0] = atomicAdd(&arrived[group], 1) == parts - 1;
    named_bar_sync();
    if (!cnt[0]) return;
    __threadfence();
    for (int ql = warp; ql < q_live; ql += CONSUMER_WARPS)
      warp_select(keys + ql * stride, (int)stride, k, my_room, lane);
    named_bar_sync();
  }
  const int p2 = pow2_at_least(k);
  auto write = [&](int ql, int j, unsigned long long x) {
    const size_t o = ((size_t)split * Q + q_base + ql) * k + j;
    const bool real = (x >> 32) != 0;
    part_v[o] = real ? fvalue((uint32_t)(x >> 32)) : -CUDART_INF_F;
    part_i[o] = real ? (int)(0xffffffffu - (uint32_t)x) : 0;
  };
  if (p2 <= 32) {
    // one warp's registers: a bitonic sort by shuffles
    for (int ql = warp; ql < q_live; ql += CONSUMER_WARPS) {
      const int n = parts > 1 ? k : cnt[ql];
      unsigned long long x = lane < n ? keys[ql * stride + lane] : 0ull;  // 0 sorts last
      for (int size = 2; size <= 32; size <<= 1)
        for (int st = size >> 1; st > 0; st >>= 1) {
          const unsigned long long y = __shfl_xor_sync(FULL, x, st);
          const bool desc = (lane & size) == 0, lower = (lane & st) == 0;
          x = (lower == desc) ? (x > y ? x : y) : (x < y ? x : y);
        }
      if (lane < k) write(ql, lane, x);
    }
    return;
  }
  if constexpr (WIDE) {
    // every consumer warp sorts the live keys, in the ring (free now)
    const size_t out = ((size_t)split * Q + q_base) * k;
    sort_live(keys, stride, cnt, q_live, k, parts > 1, part_v + out, part_i + out);
  } else {
    // Never reached: this instance runs k <= 32 alone, which returned
    // above. It is the one-warp sort that larger k took before sort_live,
    // kept so that ptxas compiles the k <= 32 instances as it did then:
    // the same registers and spills, and the same per-tile loop. Without
    // it the k = 10 partial ran 2.0-3.3 % slower at Q = 32 ("highest")
    // and 2.8-9.0 % at Q = 256 ("default"), in each of three A/B calls
    // on an H100 80GB HBM3 at 700 W (PERF.md, section 6):
    // a bitonic network in shared memory, p2 keys a warp
    const int sorters = min(CONSUMER_WARPS, (int)((size_t)stages * STAGE / (8 * (size_t)p2)));
    if (warp >= sorters) return;
    unsigned long long* area = reinterpret_cast<unsigned long long*>(ring) + (size_t)warp * p2;
    for (int ql = warp; ql < q_live; ql += sorters) {
      const int n = parts > 1 ? k : cnt[ql];
      for (int i = lane; i < p2; i += 32) area[i] = i < n ? keys[ql * stride + i] : 0ull;
      __syncwarp();
      for (int size = 2; size <= p2; size <<= 1)
        for (int st = size >> 1; st > 0; st >>= 1) {
          for (int i = lane; i < p2 / 2; i += 32) {
            const int lo = 2 * i - (i & (st - 1));
            const int hi = lo + st;
            const bool desc = (lo & size) == 0;
            const unsigned long long x = area[lo], y = area[hi];
            if ((x < y) == desc) { area[lo] = y; area[hi] = x; }
          }
          __syncwarp();
        }
      for (int j = lane; j < k; j += 32) write(ql, j, area[j]);
      __syncwarp();
    }
  }
}

// exclusive block scan of two counts; returns the block's total of the first
__device__ int scan2(int& a, int& b, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
  for (int off = 1; off < 32; off <<= 1) {
    const int ua = __shfl_up_sync(0xffffffffu, ia, off);
    const int ub = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) { ia += ua; ib += ub; }
  }
  if (lane == 31) { ws[warp] = ia; ws[32 + warp] = ib; }
  __syncthreads();
  int pa = 0, pb = 0, ta = 0;
  for (int w = 0; w < MERGE_THREADS / 32; ++w) {
    if (w < warp) { pa += ws[w]; pb += ws[32 + w]; }
    ta += ws[w];
  }
  a = pa + ia - a;
  b = pb + ib - b;
  return ta;
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i, int Q,
             int splits, int kp, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = splits * kp;
  const int P2 = pow2_at_least(k);
  unsigned long long* srt = reinterpret_cast<unsigned long long*>(smem_raw);  // [P2]
  uint32_t* key = reinterpret_cast<uint32_t*>(srt + P2);                     // [C]
  __shared__ uint32_t hist[256];
  __shared__ int ws[64];
  __shared__ uint32_t s_prefix;
  __shared__ int s_need, s_done;
  const int tid = threadIdx.x, lane = tid & 31;
  const int qg = blockIdx.x;
  auto at = [&](int p) { return ((size_t)(p / kp) * Q + qg) * kp + (p % kp); };

  // position p = split*kp + j: split order, so position order is slot order
  // among equal values; four loads in flight per thread
  for (int base = 0; base < C; base += 4 * MERGE_THREADS) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = base + u * MERGE_THREADS + tid;
      v[u] = p < C ? part_v[at(p)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = base + u * MERGE_THREADS + tid;
      if (p < C) key[p] = fkey(v[u]);
    }
  }
  if (tid == 0) { s_prefix = 0; s_need = k; s_done = 0; }

  // radix select of the k-th largest key, 8 bits a pass from the top; it
  // stops early once every key of the chosen bin is needed
  uint32_t mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;  // MERGE_THREADS == 256 bins
    __syncthreads();
    const uint32_t prefix = s_prefix;
    for (int base = 0; base < C; base += MERGE_THREADS) {
      const int p = base + tid;
      const uint32_t u = p < C ? key[p] : 0u;
      const bool in = p < C && (u & mask) == prefix;
      const uint32_t bin = in ? (u >> shift) & 255u : 256u;
      // one atomic per distinct bin of the warp: most keys share a bin
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], (uint32_t)__popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      // lane l sums bins 255-8l .. 248-8l (top first)
      int cnt[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) { cnt[j] = (int)hist[255 - 8 * lane - j]; sum += cnt[j]; }
      int incl = sum;
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      const int need = s_need;
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
      const int owner = __ffs(hit) - 1;
      if (lane == owner) {
        int above = incl - sum;
        int j = 0;
        while (above + cnt[j] < need) above += cnt[j++];
        s_prefix = prefix | ((uint32_t)(255 - 8 * lane - j) << shift);
        s_need = need - above;
        s_done = cnt[j] == need - above;
      }
    }
    mask |= 255u << shift;
    __syncthreads();
    if (s_done) break;
  }
  const uint32_t kth = s_prefix;  // the k-th key's bits under `mask`
  const int n_eq = s_need;        // keys equal to it under `mask` to keep

  // keep every key above the k-th and the first n_eq equal to it, in
  // position order: each thread takes a contiguous range of positions
  const int per = (C + MERGE_THREADS - 1) / MERGE_THREADS;
  const int p0 = min(C, tid * per), p1 = min(C, p0 + per);
  int n_gt = 0, n_e = 0;
  for (int p = p0; p < p1; ++p) {
    const uint32_t u = key[p] & mask;
    n_gt += u > kth;
    n_e += u == kth;
  }
  const int tot_gt = scan2(n_gt, n_e, ws);
  for (int p = p0; p < p1; ++p) {
    const uint32_t u = key[p];
    const unsigned long long comp =
        ((unsigned long long)u << 32) | (unsigned long long)(0xffffffffu - (uint32_t)p);
    if ((u & mask) > kth) srt[n_gt++] = comp;
    else if ((u & mask) == kth && n_e < n_eq) srt[tot_gt + n_e++] = comp;
  }
  for (int i = k + tid; i < P2; i += MERGE_THREADS) srt[i] = 0ull;  // sorts last
  __syncthreads();

  // sort descending by (key, then lower position): in one warp's
  // registers up to 32 entries, else a bitonic network in shared memory
  if (P2 <= 32) {
    if (tid >= 32) return;
    unsigned long long x = lane < P2 ? srt[lane] : 0ull;
    for (int size = 2; size <= 32; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, stride);
        const bool desc = (lane & size) == 0, lower = (lane & stride) == 0;
        x = (lower == desc) ? (x > y ? x : y) : (x < y ? x : y);
      }
    if (lane < k) {
      const size_t o = at((int)(0xffffffffu - (uint32_t)(x & 0xffffffffull)));
      out_v[(size_t)qg * k + lane] = part_v[o];
      out_i[(size_t)qg * k + lane] = part_i[o];
    }
    return;
  }
  for (int size = 2; size <= P2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P2 / 2; i += MERGE_THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long x = srt[lo], y = srt[hi];
        if ((x < y) == desc) { srt[lo] = y; srt[hi] = x; }
      }
      __syncthreads();
    }
  for (int j = tid; j < k; j += MERGE_THREADS) {
    const size_t o = at((int)(0xffffffffu - (uint32_t)(srt[j] & 0xffffffffull)));
    out_v[(size_t)qg * k + j] = part_v[o];
    out_i[(size_t)qg * k + j] = part_i[o];
  }
}

size_t merge_smem_bytes(int C, int k) {
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  return sizeof(unsigned long long) * p2 + sizeof(uint32_t) * (size_t)C;
}

// -- the run merge -----------------------------------------------------------

// Two searches of a non-increasing run at once, so that their loads
// overlap: the end of the prefix of positions [a0, a1) whose keys are
// above x, and of [b0, b1) whose keys are at least y.
__device__ __forceinline__ int2 prefix_ends(const float* __restrict__ run, int a0, int a1,
                                            uint32_t x, int b0, int b1, uint32_t y) {
  while (a0 < a1 || b0 < b1) {
    const int am = (a0 + a1) >> 1, bm = (b0 + b1) >> 1;
    const uint32_t ua = a0 < a1 ? fkey(run[am]) : 0u, ub = b0 < b1 ? fkey(run[bm]) : 0u;
    if (a0 < a1) {
      if (ua > x) a0 = am + 1;
      else a1 = am;
    }
    if (b0 < b1) {
      if (ub >= y) b0 = bm + 1;
      else b1 = bm;
    }
  }
  return make_int2(a0, b0);
}

// a block-wide reduction of the run merge's threads by `op`; `ws` is 8
// words of shared memory, free again when it returns
template <class F>
__device__ uint32_t block_reduce(uint32_t v, F op, uint32_t* ws) {
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(FULL, v, off));
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = v;
  __syncthreads();
  v = ws[0];
  for (int w = 1; w < MERGE_THREADS / 32; ++w) v = op(v, ws[w]);
  __syncthreads();
  return v;
}

// a[0..n) (shared, written before a barrier) to its exclusive prefix sums
// and a[n] to their total, which it returns; each thread takes a
// contiguous range
__device__ int block_scan(int* a, int n, uint32_t* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + MERGE_THREADS - 1) / MERGE_THREADS;
  const int b = min(n, (int)threadIdx.x * per), e = min(n, b + per);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += a[i];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) ws[warp] = (uint32_t)incl;
  __syncthreads();
  int run = incl - sum, total = 0;
  for (int w = 0; w < MERGE_THREADS / 32; ++w) {
    if (w < warp) run += (int)ws[w];
    total += (int)ws[w];
  }
  for (int i = b; i < e; ++i) {
    const int x = a[i];
    a[i] = run;
    run += x;
  }
  if (threadIdx.x == 0) a[n] = total;
  __syncthreads();
  return total;
}

// the run that holds flat position f < off[S] of the runs' ranges laid end
// to end (off: their exclusive prefix sums)
__device__ __forceinline__ int run_of(const int* off, int S, int f) {
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= f) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

size_t cut_smem_bytes(int S) {
  return sizeof(int) * (3 * (size_t)S + 1) + sizeof(uint32_t) * WINDOW_KEYS;
}

// The co-rank of the rank r = min(k, (blockIdx.x + 1) * SEG) of query
// blockIdx.y: cuts[q][blockIdx.x][s] = the entries of run s among the top
// r in the order (key descending, run, position).
__global__ void __launch_bounds__(MERGE_THREADS)
cut_kernel(const float* __restrict__ part_v, int Q, int S, int kp, int k, int* __restrict__ cuts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* hi = reinterpret_cast<int*>(smem_raw);  // [S] a run's window start (keys above U before it)
  int* lo = hi + S;                            // [S] its end (keys below L, or position r, from it)
  int* off = lo + S;                           // [S + 1] the windows' offsets, then the ties'
  uint32_t* win = reinterpret_cast<uint32_t*>(off + S + 1);  // [WINDOW_KEYS] the windows' keys
  __shared__ uint32_t hist[256];
  __shared__ uint32_t ws[MERGE_THREADS / 32];
  __shared__ uint32_t s_prefix;
  __shared__ int s_need, s_whole;
  const int tid = threadIdx.x, lane = tid & 31, q = blockIdx.y;
  const int r = min(k, ((int)blockIdx.x + 1) * SEG);
  // key(a) of every run is at least the r-th key and key(b) of some run at
  // most it; a run gives nothing at or past position r
  const int a = (r + S - 1) / S - 1, b = (r - 1) / S, end = min(kp, r);
  auto run = [&](int s) { return part_v + ((size_t)s * Q + q) * kp; };

  // the r-th key lies in [L, U]
  uint32_t mn = ~0u, mx = 0u;
  for (int s = tid; s < S; s += MERGE_THREADS) {
    const float* x = run(s);
    mn = min(mn, fkey(x[a]));
    mx = max(mx, fkey(x[b]));
  }
  uint32_t L = block_reduce(mn, [](uint32_t u, uint32_t v) { return min(u, v); }, ws);
  uint32_t U = block_reduce(mx, [](uint32_t u, uint32_t v) { return max(u, v); }, ws);
  auto sum = [](uint32_t u, uint32_t v) { return u + v; };

  // each run's window [hi, lo): its keys in [L, U] before position r; the
  // keys above U are all kept
  int above = 0;
  for (int s = tid; s < S; s += MERGE_THREADS) {
    const int2 e = prefix_ends(run(s), 0, b, U, a + 1, end, L);
    hi[s] = e.x;
    lo[s] = e.y;
    off[s] = e.y - e.x;
    above += e.x;
  }
  above = (int)block_reduce((uint32_t)above, sum, ws);
  int W = block_scan(off, S, ws);
  if (W > WINDOW_KEYS) {
    // A run far shorter than the rest (a split's tail, a shard's list of
    // few live rows) holds L far below the r-th key, and the windows
    // outgrow shared memory: every pass of the select then reads them
    // from L2 again. Bisect [L, U] by key until they fit, counting each
    // run's keys at or above the midpoint m before position r: the r-th
    // key is at least m if they are r or more, else below m.
    int at_least_L = above + W;
    while (at_least_L - above > WINDOW_KEYS && L < U) {
      const uint32_t m = (uint32_t)(((unsigned long long)L + U + 1) >> 1);  // L < m <= U
      int ge = 0;
      for (int s = tid; s < S; s += MERGE_THREADS) ge += prefix_ends(run(s), 0, 0, 0u, 0, end, m).y;
      ge = (int)block_reduce((uint32_t)ge, sum, ws);
      if (ge >= r) {
        L = m;
        at_least_L = ge;
      } else {
        U = m - 1;
        above = ge;  // the keys above U are those at or above m
      }
    }
    // the windows again, each searched over the run's whole prefix
    for (int s = tid; s < S; s += MERGE_THREADS) {
      const int2 e = prefix_ends(run(s), 0, end, U, 0, end, L);
      hi[s] = e.x;
      lo[s] = e.y;
      off[s] = e.y - e.x;
    }
    __syncthreads();
    W = block_scan(off, S, ws);
  }
  const bool held = W <= WINDOW_KEYS;
  auto load = [&](int f) {
    const int s = run_of(off, S, f);
    return fkey(run(s)[hi[s] + f - off[s]]);
  };
  if (held) {
#pragma unroll 4
    for (int f = tid; f < W; f += MERGE_THREADS) win[f] = load(f);
    __syncthreads();
  }

  // the r-th key, the need-th of the windows' keys: a radix select, 8 bits
  // a pass from the highest bit in which L and U differ (every window key
  // shares the bits above it), over the keys in shared memory or, when
  // they do not fit, read again each pass; it stops once every key of the
  // chosen bin is needed (`whole`)
  int need = r - above;
  uint32_t prefix = L;
  bool whole = false;
  if (L != U) {
    int top = 31 - __clz(L ^ U);
    uint32_t mask = top == 31 ? 0u : ~0u << (top + 1);
    prefix = L & mask;
    while (top >= 0) {
      const int shift = top > 7 ? top - 7 : 0;
      const uint32_t digit = (1u << (top - shift + 1)) - 1;
      hist[tid] = 0;  // MERGE_THREADS == 256 bins
      __syncthreads();
      for (int f = tid; f < W; f += MERGE_THREADS) {
        const uint32_t u = held ? win[f] : load(f);
        if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & digit], 1u);
      }
      __syncthreads();
      if (tid < 32) {
        // lane l sums bins 255-8l .. 248-8l (top first)
        int cnt[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) { cnt[j] = (int)hist[255 - 8 * lane - j]; sum += cnt[j]; }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += u;
        }
        const int owner = __ffs(__ballot_sync(FULL, incl >= need)) - 1;
        if (lane == owner) {
          int up = incl - sum, j = 0;
          while (up + cnt[j] < need) up += cnt[j++];
          s_prefix = prefix | ((uint32_t)(255 - 8 * lane - j) << shift);
          s_need = need - up;
          s_whole = cnt[j] == need - up;
        }
      }
      __syncthreads();
      prefix = s_prefix;
      need = s_need;
      whole = s_whole;
      mask |= digit << shift;
      top = shift - 1;
      if (whole) break;
    }
  }

  // each run's count: its window keys above the r-th key, then those equal
  // to it, the lowest runs first; with a whole bin, every key at or above
  // its least value (prefix)
  for (int s = tid; s < S; s += MERGE_THREADS) {
    const int2 e = prefix_ends(run(s), hi[s], lo[s], prefix, hi[s], lo[s], prefix);
    hi[s] = e.x;               // above the r-th key
    off[s] = e.y - e.x;        // equal to it
  }
  __syncthreads();
  if (!whole) block_scan(off, S, ws);
  int* out = cuts + ((size_t)q * gridDim.x + blockIdx.x) * S;
  for (int s = tid; s < S; s += MERGE_THREADS)
    out[s] = hi[s] + (whole ? off[s] : min(off[s + 1] - off[s], max(0, need - off[s])));
}

// Segment blockIdx.x of query blockIdx.y: ranks r0 = blockIdx.x * SEG up to
// SEG more, the entries [cut of the segment before, cut of this one) of
// each run, each placed by its rank among them.
__global__ void __launch_bounds__(MERGE_THREADS)
place_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i, int Q, int S,
             int kp, int k, const int* __restrict__ cuts, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* off = reinterpret_cast<int*>(smem_raw);  // [S + 1] the segment's ranges of the runs
  __shared__ unsigned long long comp[SEG];
  __shared__ uint32_t ws[MERGE_THREADS / 32];
  const int tid = threadIdx.x, g = blockIdx.x, q = blockIdx.y;
  const int r0 = g * SEG;
  const int* c1 = cuts + ((size_t)q * gridDim.x + g) * S;
  const int* c0 = g ? c1 - S : nullptr;
  for (int s = tid; s < S; s += MERGE_THREADS) off[s] = max(0, c1[s] - (g ? c0[s] : 0));
  __syncthreads();
  // the bounds keep a run that increases (a broken precondition) from
  // reading or writing out of range; its output is then undefined
  const int n = min(min(k, r0 + SEG) - r0, block_scan(off, S, ws));
  size_t o = 0;
  float v = 0.f;
  if (tid < n) {
    const int s = run_of(off, S, tid);
    const int j = min(kp - 1, (g ? c0[s] : 0) + tid - off[s]);
    o = ((size_t)s * Q + q) * kp + j;
    v = part_v[o];
    // (key, then the earlier run and position first), as in merge_kernel
    comp[tid] = ((unsigned long long)fkey(v) << 32) | (0xffffffffu - (uint32_t)(s * kp + j));
  }
  __syncthreads();
  if (tid < n) {
    const unsigned long long x = comp[tid];
    int rank = 0;
    for (int i = 0; i < n; ++i) rank += comp[i] > x;
    const size_t w = (size_t)q * k + r0 + rank;
    out_v[w] = v;
    out_i[w] = part_i[o];
  }
}

// cuTensorMapEncodeTiled, a driver-API call, reached through the runtime
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// maps of the index [N, D] (boxes of 128 rows x 32 dims) and of the split
// queries [parts, Q, D] (boxes of nq queries x 32 dims of one part), both
// in the 128-byte swizzle, out-of-bounds elements zero-filled
int encode_maps(CUtensorMap* db_map, CUtensorMap* q_map, const float* db, const float* qs, int N,
                int Q, int D, int nq, int parts) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t one[3] = {1, 1, 1};
  const cuuint64_t db_dim[2] = {(cuuint64_t)D, (cuuint64_t)N};
  const cuuint64_t db_stride[1] = {(cuuint64_t)D * 4};
  const cuuint32_t db_box[2] = {DK, TM};
  CUresult r = enc(db_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)db, db_dim, db_stride, db_box,
                   one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t q_dim[3] = {(cuuint64_t)D, (cuuint64_t)Q, (cuuint64_t)parts};
  const cuuint64_t q_stride[2] = {(cuuint64_t)D * 4, (cuuint64_t)Q * D * 4};
  const cuuint32_t q_box[3] = {DK, (cuuint32_t)nq, 1};
  r = enc(q_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)qs, q_dim, q_stride, q_box, one,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NQ, int PASSES, bool WIDE>
int launch_partial(const float* q, float* qs, const float* db, const unsigned char* valid,
                   const float* sq, int Q, int N, int D, int k, int l2sq, int rows_per_split,
                   int splits, int parts, int stages, unsigned long long* buf,
                   unsigned long long* mbuf, int* arrived, float* part_v, int* part_i,
                   cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(NQ, stages, k, buf == nullptr, PASSES);
  cudaError_t err = cudaFuncSetAttribute(partial_kernel<NQ, PASSES, WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_kernel<PASSES><<<(Q * D + 255) / 256, 256, 0, stream>>>(q, qs, Q * D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  CUtensorMap db_map, q_map;
  const int e = encode_maps(&db_map, &q_map, db, qs, N, Q, D, NQ, query_parts(PASSES));
  if (e) return e;
  dim3 grid((Q + NQ - 1) / NQ, splits * parts);
  partial_kernel<NQ, PASSES, WIDE><<<grid, THREADS, smem, stream>>>(
      db_map, q_map, q, valid, sq, Q, N, D, k, l2sq, rows_per_split, parts, stages, capacity(k),
      buf, mbuf, arrived, part_v, part_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_knn_k_max() { return K_MAX; }
int fused_knn_row_granule() { return ROW_GRANULE; }
int fused_knn_merge_max() { return MERGE_MAX; }
int fused_knn_merge_segment() { return SEG; }
int fused_knn_runs_max() { return RUNS_MAX; }
int fused_knn_capacity(int k) { return capacity(k); }
int fused_knn_sort_bytes(int k) { return sort_bytes(k); }
long long fused_knn_partial_smem(int nq, int stages, int k, int smem_buffers, int passes) {
  return (long long)partial_smem_bytes(nq, stages, k, smem_buffers != 0, passes);
}

// All pointers are device pointers; `stream` is a cudaStream_t. `nq`,
// `passes` and k pick the instance (8, 16, 32 or 64 queries a CTA; 3 TF32
// passes for precision "highest", 1 for "default"; k <= 32 or above), `parts` the CTAs that share a
// split's rows (at most 8), `stages` the ring depth (4..8); `qs` is
// [2, Q, D] f32 scratch for the split queries (hi and lo; [1, Q, D], hi
// alone, with one pass); `buf` is
// [ceil(Q/nq) * splits * parts, nq, capacity(k)] 64-bit scratch for the
// candidate buffers, or null to keep them in shared memory; with parts > 1
// `mbuf` is [ceil(Q/nq) * splits, nq, parts * k] 64-bit scratch for the
// parts' lists and `arrived` [ceil(Q/nq) * splits] int32 zeros. Returns the
// launch's cudaError_t (0 on success).
int fused_knn_partial(const float* q, float* qs, const float* db, const unsigned char* valid,
                      const float* sq, int Q, int N, int D, int k, int l2sq,
                      int rows_per_split, int splits, int parts, int nq, int stages, int passes,
                      unsigned long long* buf, unsigned long long* mbuf, int* arrived,
                      float* part_v, int* part_i, void* stream) {
  if (k < 1 || k > K_MAX || D % 4 || rows_per_split % ROW_GRANULE || parts < 1 ||
      parts > MAX_PARTS || (parts > 1 && (!mbuf || !arrived)) ||
      stages < MIN_STAGES || stages > MAX_STAGES ||
      partial_smem_bytes(nq, stages, k, buf == nullptr, passes) > (size_t)SMEM_MAX ||
      (size_t)stages * stage_bytes(nq, passes) < (size_t)sort_bytes(k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PARTIAL(NQ_, P_)                                                                       \
  (k > 32 ? launch_partial<NQ_, P_, true>(q, qs, db, valid, sq, Q, N, D, k, l2sq, rows_per_split, \
                                          splits, parts, stages, buf, mbuf, arrived, part_v,      \
                                          part_i, s)                                              \
          : launch_partial<NQ_, P_, false>(q, qs, db, valid, sq, Q, N, D, k, l2sq, rows_per_split, \
                                           splits, parts, stages, buf, mbuf, arrived, part_v,     \
                                           part_i, s))
  switch (nq * 4 + passes) {
    case 8 * 4 + 3: return PARTIAL(8, 3);
    case 16 * 4 + 3: return PARTIAL(16, 3);
    case 32 * 4 + 3: return PARTIAL(32, 3);
    case 64 * 4 + 3: return PARTIAL(64, 3);
    case 8 * 4 + 1: return PARTIAL(8, 1);
    case 16 * 4 + 1: return PARTIAL(16, 1);
    case 32 * 4 + 1: return PARTIAL(32, 1);
    case 64 * 4 + 1: return PARTIAL(64, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PARTIAL
}

// Merges [splits, Q, kp] runs into the k <= kp best per query, taken in
// run order: `design` 0 is the one-CTA merge (splits * kp <= 32768), 1 the
// run merge (each run non-increasing in value; splits <= 8192, splits * kp
// < 2^31), which needs `cuts`, [Q, ceil(k / 256), splits] int32 scratch.
int fused_knn_merge(const float* part_v, const int* part_i, int Q, int splits, int kp,
                    int k, int design, int* cuts, float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kp || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 0) {
    if ((long long)splits * kp > MERGE_MAX) return (int)cudaErrorInvalidValue;
    const size_t smem = merge_smem_bytes(splits * kp, k);
    cudaError_t err = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    merge_kernel<<<Q, MERGE_THREADS, smem, s>>>(part_v, part_i, Q, splits, kp, k, out_v, out_i);
    return (int)cudaGetLastError();
  }
  if (design != 1 || splits > RUNS_MAX || (long long)splits * kp >= (1ll << 31) || !cuts)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((k + SEG - 1) / SEG, Q);
  const size_t cut_smem = cut_smem_bytes(splits), place_smem = sizeof(int) * (splits + 1);
  cudaError_t err = cudaFuncSetAttribute(
      cut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cut_smem);
  if (err != cudaSuccess) return (int)err;
  cut_kernel<<<grid, MERGE_THREADS, cut_smem, s>>>(part_v, Q, splits, kp, k, cuts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  place_kernel<<<grid, MERGE_THREADS, place_smem, s>>>(part_v, part_i, Q, splits, kp, k, cuts,
                                                       out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
