// Fused KNN scoring for Hopper: matmul + running top-k, without a
// [Q, cap] score matrix in device memory.
//
// Replaces the TPU kernel pathway_tpu/ops/pallas_knn.py:_knn_kernel. That
// kernel walks the database in blocks on a sequential grid and carries a
// running [Q, k] top-k in VMEM scratch from one grid step to the next.
// Blocks on Hopper run in parallel and carry nothing over, so the work is
// split in two passes:
//
//   fused_knn_partial  grid (query tiles x database splits), 8 warps. A CTA
//                      holds QPC <= QT queries (QT in 8/16/32/64/128, a
//                      template instance the wrapper picks from Q and k) and
//                      streams its contiguous range of rows through a ring
//                      of STAGES shared-memory stages of TN rows x DK dims,
//                      filled by 16-byte cp.async copies (zero fill past the
//                      split end, past d and past the CTA's queries), so the
//                      next stages load while the tensor cores work. Scores
//                      are 3xTF32 mma.sync m16n8k8: database rows on the M
//                      side, queries on the N side, each operand split into
//                      hi = tf32(x) and lo = tf32(x - hi), and lo*hi + hi*lo
//                      + hi*hi of each k-step of 8 dims added to the running
//                      sum in IEEE fp32 -- the accuracy of fp32
//                      (Precision.HIGHEST); plain TF32 is never used. The
//                      epilogue applies the valid mask as -inf and the l2sq
//                      form 2s - |q|^2 - |x|^2, drops every score at or below
//                      its query's running k-th, and writes the rest to a
//                      score tile; each warp then folds its queries' scores
//                      in ascending row order into a sorted running list of
//                      capacity k (warp-parallel insertion). Writes
//                      [splits, Q, k] partials; with one split they are the
//                      answer.
//   fused_knn_merge    one CTA of 256 threads per query: loads the splits'
//                      lists (splits*kp candidates, in split order) as
//                      order-preserving keys, finds the k-th largest by a
//                      radix select (8 bits a pass, shared histogram, at most
//                      4 passes),
//                      keeps every candidate above it and the earliest ones
//                      equal to it, and bitonic-sorts those k by (value
//                      descending, position ascending).
//
// Output contract (that of _knn_kernel): values in descending order; equal
// values ordered by lower slot first; a missing entry is -inf with a slot
// in range. The tie rule holds because a split's rows are scanned in
// ascending order, a new score enters only if strictly above the k-th (so
// after equals), splits cover ascending slot ranges, and the merge breaks
// ties by position in split order. Every row of every split goes through
// the same mma sequence in the same k order, so equal rows score
// bit-equally.
//
// Bound on an H100 SXM: the database read, 4*cap*d bytes at 3.35 TB/s
// (0.48 ms at cap=2^20, d=384), or, when Q is large, the lesser of the
// 2*Q*cap*d FP32 operations at 67 TFLOP/s and the 3 x 2*Q*cap*d TF32
// operations at 495 TFLOP/s (1.25 ms at Q=256). Operand fragments are
// read with ld.shared (ldmatrix moves 16-bit elements) from rows padded to
// DKP = 68 floats, which puts the 32 lanes of a fragment load on 32 banks.
//
// Limits: 1 <= k <= 8192, d % 4 == 0, 16-byte aligned rows, splits*kp <=
// 32768 merge candidates.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// 64 dims make 256 contiguous bytes of each row a stage: shorter pieces
// (16 or 32 dims, with 3-4 stages) read the database more slowly on the
// H100; two such stages fill the shared memory
constexpr int DK = 64;       // dims per pipeline stage (DK / 8 mma k-steps)
constexpr int DKP = DK + 4;  // padded row stride of a stage, in floats
constexpr int STAGES = 2;    // cp.async ring depth
constexpr int MT = 2;        // m16 row tiles per warp
constexpr int THREADS = 256;  // 8 warps
constexpr int K_MAX = 8192;
constexpr int ROW_GRANULE = 256;  // rows per split are a multiple of this
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_MAX = 32768;
constexpr int SMEM_MAX = 232448;  // 227 KB a block may use

// instance geometry: warps are WARPS_M x WARPS_N; a warp owns MT m16 row
// tiles and NT_W n8 tiles of queries
template <int QT> struct Geo {
  static constexpr int WARPS_N = QT >= 64 ? 2 : 1;
  static constexpr int NT_W = QT / 8 / WARPS_N;
  static constexpr int NG = NT_W < 2 ? NT_W : 2;  // n tiles per mma group
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int TN = WARPS_M * 16 * MT;  // rows per tile
  static constexpr int TNP = TN + 4;            // padded score-tile stride
};

size_t partial_smem_bytes(int qt, int qpc, int k) {
  const int tn = (qt >= 64 ? 4 : 8) * 16 * MT;
  return sizeof(float) * ((size_t)STAGES * (tn + qt) * DKP + (size_t)qt * (tn + 4) + qt) +
         (sizeof(float) + sizeof(int)) * (size_t)qpc * k;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo, each rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: cvt.rna) by integer ops, which issue at the ALU rate; the
// conversion unit's cvt.rna.tf32 issues at a fraction of it
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));  // x - hi is exact
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Insert (cv, slot) into the warp's sorted list of k after every entry >= cv;
// cv is above lv[k-1]. The tail shifts one place, 32 entries a step.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k, float cv, int slot,
                                            int lane) {
  int lo = 0, hi = k - 1;  // first j with lv[j] < cv; lv[k-1] < cv
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lv[mid] >= cv) lo = mid + 1; else hi = mid;
  }
  const int p = lo;
  for (int base = k - 1; base > p; base -= 32) {
    const int j = base - lane;
    float v = 0.f;
    int s = 0;
    if (j > p) { v = lv[j - 1]; s = li[j - 1]; }
    __syncwarp();
    if (j > p) { lv[j] = v; li[j] = s; }
    __syncwarp();
  }
  if (lane == 0) { lv[p] = cv; li[p] = slot; }
  __syncwarp();
}

// Fold one query's tile of scores, in ascending row order, into its sorted
// running list of k > 32 in shared memory.
__device__ __forceinline__ void fold_shared(float* lv, int* li, int k, const float* sc, int tn,
                                            int tile, int lane) {
  float thr = lv[k - 1];
  for (int i = 0; i < tn / 32; ++i) {
    const float v = sc[32 * i + lane];
    unsigned msk = __ballot_sync(0xffffffffu, v > thr);
    while (msk) {
      const int src = __ffs(msk) - 1;
      msk &= msk - 1;
      const float cv = __shfl_sync(0xffffffffu, v, src);
      if (cv > thr) {
        warp_insert(lv, li, k, cv, tile + 32 * i + src, lane);
        thr = lv[k - 1];
      }
    }
  }
}

// The same for k <= 32: lane j holds entry j in registers for the tile, so
// an insertion is a ballot and a shuffle, not a chain of shared-memory
// round trips (the main path's k = 10 spends much of its fold inserting
// at the start of each split).
__device__ __forceinline__ void fold_lanes(float* lv, int* li, int k, const float* sc, int tn,
                                           int tile, int lane) {
  float rv = lane < k ? lv[lane] : -CUDART_INF_F;
  int ri = lane < k ? li[lane] : 0;
  float thr = __shfl_sync(0xffffffffu, rv, k - 1);
  bool changed = false;
  for (int i = 0; i < tn / 32; ++i) {
    const float v = sc[32 * i + lane];
    unsigned msk = __ballot_sync(0xffffffffu, v > thr);
    while (msk) {
      const int src = __ffs(msk) - 1;
      msk &= msk - 1;
      const float cv = __shfl_sync(0xffffffffu, v, src);
      if (cv > thr) {
        // after every entry >= cv: entries p.. move down one lane
        const int p = __popc(__ballot_sync(0xffffffffu, lane < k && rv >= cv));
        const float up_v = __shfl_up_sync(0xffffffffu, rv, 1);
        const int up_i = __shfl_up_sync(0xffffffffu, ri, 1);
        if (lane > p) { rv = up_v; ri = up_i; }
        if (lane == p) { rv = cv; ri = tile + 32 * i + src; }
        thr = __shfl_sync(0xffffffffu, rv, k - 1);
        changed = true;
      }
    }
  }
  if (changed && lane < k) { lv[lane] = rv; li[lane] = ri; }
  __syncwarp();
}

template <int QT>
__global__ void __launch_bounds__(THREADS, 1)
partial_kernel(const float* __restrict__ q, const float* __restrict__ db,
               const unsigned char* __restrict__ valid, const float* __restrict__ sq, int Q,
               int N, int D, int k, int qpc, int l2sq, int rows_per_split,
               float* __restrict__ part_v, int* __restrict__ part_i) {
  using G = Geo<QT>;
  constexpr int TN = G::TN, TNP = G::TNP, NT_W = G::NT_W, NG = G::NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ds = reinterpret_cast<float*>(smem_raw);  // [STAGES][TN][DKP]
  float* qs = ds + STAGES * TN * DKP;              // [STAGES][QT][DKP]
  float* sc = qs + STAGES * QT * DKP;              // [QT][TNP] scores
  float* qn = sc + QT * TNP;                       // [QT] |q|^2
  float* lv = qn + QT;                             // [qpc][k] running values
  int* li = reinterpret_cast<int*>(lv + qpc * k);  // [qpc][k] running slots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID, thread in group
  const int warp_m = warp % G::WARPS_M, warp_n = warp / G::WARPS_M;
  const int q_base = blockIdx.x * qpc;
  const int q_live = min(qpc, Q - q_base);  // queries this CTA answers
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  // n8 tiles of this warp that hold one of the CTA's queries
  const int n_live = min(NT_W, max(0, (q_live - warp_n * NT_W * 8 + 7) / 8));
  const int nd = (D + DK - 1) / DK;
  const int total = (row_end - row_begin + TN - 1) / TN * nd;

  for (int i = tid; i < qpc * k; i += THREADS) { lv[i] = -CUDART_INF_F; li[i] = 0; }
  for (int ql = warp; ql < QT; ql += 8) {
    float acc = 0.f;
    if (l2sq && ql < q_live)
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)(q_base + ql) * D + d];
        acc = fmaf(v, v, acc);
      }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) qn[ql] = acc;
  }

  auto issue = [&](int c) {
    if (c < total) {
      const int st = c % STAGES;
      const int row0 = row_begin + (c / nd) * TN;
      const int d0 = (c % nd) * DK;
      float* dst = ds + st * TN * DKP;
      for (int i = tid; i < TN * (DK / 4); i += THREADS) {
        const int r = i / (DK / 4), cc = i % (DK / 4) * 4;
        const bool ok = row0 + r < row_end && d0 + cc < D;
        cp_async16(dst + r * DKP + cc, ok ? db + (size_t)(row0 + r) * D + d0 + cc : db, ok);
      }
      float* qdst = qs + st * QT * DKP;
      for (int i = tid; i < QT * (DK / 4); i += THREADS) {
        const int r = i / (DK / 4), cc = i % (DK / 4) * 4;
        const bool ok = r < q_live && d0 + cc < D;
        cp_async16(qdst + r * DKP + cc, ok ? q + (size_t)(q_base + r) * D + d0 + cc : q, ok);
      }
    }
    cp_async_commit();  // one group per chunk, empty or not
  };

  float acc[MT][NT_W][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT_W; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  bool row_ok[MT][2];
  float row_sq[MT][2];
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(c + STAGES - 1);
    const float* a_s = ds + (c % STAGES) * TN * DKP + (warp_m * 16 * MT) * DKP;
    if (c % nd == 0) {
      // the tile's validity and norms, loaded now and read in its epilogue
      const int tile = row_begin + (c / nd) * TN;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = tile + warp_m * 16 * MT + m * 16 + g + 8 * h;
          row_ok[m][h] = row < row_end && valid[row];
          row_sq[m][h] = (row_ok[m][h] && l2sq) ? sq[row] : 0.f;
        }
    }
    const float* b_s = qs + (c % STAGES) * QT * DKP + (warp_n * NT_W * 8) * DKP;
#pragma unroll
    for (int ks = 0; ks < DK; ks += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* a = a_s + (m * 16 + g) * DKP + ks + t4;
        split_tf32(a[0], ah[m][0], al[m][0]);
        split_tf32(a[8 * DKP], ah[m][1], al[m][1]);
        split_tf32(a[4], ah[m][2], al[m][2]);
        split_tf32(a[8 * DKP + 4], ah[m][3], al[m][3]);
      }
      // NG n tiles at a time: each k-step's products go to a fresh
      // accumulator, added to the running sum in IEEE fp32 (the tensor
      // cores' own additions truncate, and a long chain of them drifts by
      // several ulps); small terms first, and consecutive mmas go to
      // different accumulators. n tiles past the CTA's queries are skipped.
#pragma unroll
      for (int n0 = 0; n0 < NT_W; n0 += NG) {
        if (n0 >= n_live) break;
        uint32_t bh[NG][2], bl[NG][2];
        float t[NG][MT][4];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const float* b = b_s + ((n0 + j) * 8 + g) * DKP + ks + t4;
          split_tf32(b[0], bh[j][0], bl[j][0]);
          split_tf32(b[4], bh[j][1], bl[j][1]);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i) t[j][m][i] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_tf32(t[j][m], al[m], bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_tf32(t[j][m], ah[m], bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_tf32(t[j][m], ah[m], bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][n0 + j][i] += t[j][m][i];
      }
    }
    if (c % nd != nd - 1) continue;

    // epilogue: mask, l2sq form, threshold filter -> score tile
    const int tile = row_begin + (c / nd) * TN;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp_m * 16 * MT + m * 16 + g + 8 * h;
        const bool ok = row_ok[m][h];
        const float sqn = row_sq[m][h];
#pragma unroll
        for (int n = 0; n < NT_W; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ql = (warp_n * NT_W + n) * 8 + t4 * 2 + e;
            float v = acc[m][n][2 * h + e];
            if (l2sq) v = 2.f * v - qn[ql] - sqn;
            const bool keep = ok && ql < q_live && v > lv[ql * k + k - 1];
            sc[ql * TNP + r] = keep ? v : -CUDART_INF_F;
            acc[m][n][2 * h + e] = 0.f;
          }
      }
    __syncthreads();

    // fold: warp w owns queries w, w+8, ...; rows in ascending order
    for (int ql = warp; ql < q_live; ql += 8) {
      if (k <= 32)
        fold_lanes(lv + ql * k, li + ql * k, k, sc + ql * TNP, TN, tile, lane);
      else
        fold_shared(lv + ql * k, li + ql * k, k, sc + ql * TNP, TN, tile, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // partials [split][Q][k]
  for (int i = tid; i < q_live * k; i += THREADS) {
    const size_t o = ((size_t)split * Q + q_base + i / k) * k + (i % k);
    part_v[o] = lv[i];
    part_i[o] = li[i];
  }
}

// order-preserving key: a larger float gives a larger key; -0 counts as +0
__device__ __forceinline__ uint32_t fkey(float v) {
  if (v == 0.f) v = 0.f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
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

template <int QT>
int launch_partial(const float* q, const float* db, const unsigned char* valid, const float* sq,
                   int Q, int N, int D, int k, int qpc, int l2sq, int rows_per_split, int splits,
                   float* part_v, int* part_i, cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(QT, qpc, k);
  cudaError_t err = cudaFuncSetAttribute(partial_kernel<QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + qpc - 1) / qpc, splits);
  partial_kernel<QT><<<grid, THREADS, smem, stream>>>(q, db, valid, sq, Q, N, D, k, qpc, l2sq,
                                                       rows_per_split, part_v, part_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_knn_k_max() { return K_MAX; }
int fused_knn_row_granule() { return ROW_GRANULE; }
int fused_knn_merge_max() { return MERGE_MAX; }
long long fused_knn_partial_smem(int qt, int qpc, int k) {
  return (long long)partial_smem_bytes(qt, qpc, k);
}

// All pointers are device pointers; `stream` is a cudaStream_t. `qt` is the
// instance (8, 16, 32, 64 or 128 queries), `qpc` <= qt the queries each CTA
// answers. Returns the launch's cudaError_t (0 on success).
int fused_knn_partial(const float* q, const float* db, const unsigned char* valid,
                      const float* sq, int Q, int N, int D, int k, int l2sq,
                      int rows_per_split, int splits, int qt, int qpc, float* part_v,
                      int* part_i, void* stream) {
  if (k < 1 || k > K_MAX || D % 4 || rows_per_split % ROW_GRANULE || qpc < 1 || qpc > qt ||
      partial_smem_bytes(qt, qpc, k) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (qt) {
    case 8: return launch_partial<8>(q, db, valid, sq, Q, N, D, k, qpc, l2sq, rows_per_split, splits, part_v, part_i, s);
    case 16: return launch_partial<16>(q, db, valid, sq, Q, N, D, k, qpc, l2sq, rows_per_split, splits, part_v, part_i, s);
    case 32: return launch_partial<32>(q, db, valid, sq, Q, N, D, k, qpc, l2sq, rows_per_split, splits, part_v, part_i, s);
    case 64: return launch_partial<64>(q, db, valid, sq, Q, N, D, k, qpc, l2sq, rows_per_split, splits, part_v, part_i, s);
    case 128: return launch_partial<128>(q, db, valid, sq, Q, N, D, k, qpc, l2sq, rows_per_split, splits, part_v, part_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Merges [splits, Q, kp] partials into the k <= kp best per query.
int fused_knn_merge(const float* part_v, const int* part_i, int Q, int splits, int kp,
                    int k, float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kp || splits < 1 || (long long)splits * kp > MERGE_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = merge_smem_bytes(splits * kp, k);
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<Q, MERGE_THREADS, smem, (cudaStream_t)stream>>>(part_v, part_i, Q, splits, kp,
                                                                 k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
