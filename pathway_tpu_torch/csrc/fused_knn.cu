// Fused KNN scoring for Hopper: matmul + running top-k, without a
// [Q, cap] score matrix in device memory.
//
// Replaces the TPU kernel pathway_tpu/ops/pallas_knn.py:_knn_kernel. That
// kernel walks the database in blocks on a sequential grid and carries a
// running [Q, k] top-k in VMEM scratch from one grid step to the next.
// Blocks on Hopper run in parallel and carry nothing over, so the work is
// split in two passes:
//
//   fused_knn_partial  grid (query tiles x database splits). Each CTA keeps
//                      QT=32 queries, streams its contiguous range of rows
//                      through shared memory in tiles of TN=256 rows x DK=32
//                      dims, scores with FP32 FMA (IEEE; no TF32), applies
//                      the valid mask as -inf and the optional l2sq epilogue
//                      2s - |q|^2 - |x|^2, and folds each tile into a sorted
//                      per-query running top-k in shared memory. Only a
//                      score above the running k-th can enter, so after the
//                      first tiles the fold is one compare and one ballot
//                      per score. Writes [splits, Q, k] partials.
//   fused_knn_merge    one warp per query: loads the splits' partial lists
//                      into shared memory in split order and keeps the k
//                      best by k rounds of warp arg-max.
//
// Output contract (that of _knn_kernel): values in descending order; equal
// values ordered by lower slot first; a missing entry is -inf with a slot
// in range. The tie rule holds because a split's rows are scanned in
// ascending order, a new score enters only if strictly above the k-th (so
// after equals), splits cover ascending slot ranges, and the merge breaks
// ties by position in split order.
//
// Bound on an H100 SXM: the database read, 4*cap*d bytes at 3.35 TB/s
// (0.48 ms at cap=2^20, d=384), or, when Q is large, the 2*Q*cap*d FP32
// operations at 67 TFLOP/s (3.1 ms at Q=256). The design streams the
// database once per query tile and keeps scores on chip; a warp group whose
// 8 queries are all past Q skips its FMAs. Tensor cores (TF32/wgmma) and
// TMA pipelining are not used: exact fp32 comes first.
//
// Limits: 1 <= k <= 128, d % 4 == 0, 16-byte aligned rows.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;        // queries per CTA
constexpr int TN = 256;       // database rows per tile
constexpr int DK = 32;        // dims per shared-memory stage
constexpr int DKP = DK + 1;   // padded row stride of the database stage
constexpr int THREADS = 256;  // 8 warps: 4 query groups x 2 row halves
constexpr int K_MAX = 128;

struct Smem {
  float* ds;   // [TN][DKP] database stage; reused as scores [QT][TN]
  float* qs;   // [DK][QT] query stage, transposed
  float* qn;   // [QT] |q|^2
  float* lv;   // [QT][k] running values, descending
  int* li;     // [QT][k] running slots
};

__device__ __forceinline__ Smem carve(unsigned char* base, int k) {
  Smem s;
  s.ds = reinterpret_cast<float*>(base);
  s.qs = s.ds + TN * DKP;
  s.qn = s.qs + DK * QT;
  s.lv = s.qn + QT;
  s.li = reinterpret_cast<int*>(s.lv + QT * k);
  return s;
}

__global__ void __launch_bounds__(THREADS)
partial_kernel(const float* __restrict__ q, const float* __restrict__ db,
               const unsigned char* __restrict__ valid,
               const float* __restrict__ sq, int Q, int N, int D, int k,
               int l2sq, int rows_per_split, float* __restrict__ part_v,
               int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve(smem_raw, k);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q_base = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);

  // running lists start empty: -inf with slot 0 (in range)
  for (int i = tid; i < QT * k; i += THREADS) {
    s.lv[i] = -CUDART_INF_F;
    s.li[i] = 0;
  }
  // |q|^2 for the l2sq epilogue: warp w sums queries 4w..4w+3
  for (int j = 0; j < 4; ++j) {
    const int ql = warp * 4 + j;
    const int qg = q_base + ql;
    float acc = 0.f;
    if (l2sq && qg < Q) {
      for (int d = lane; d < D; d += 32) {
        const float v = q[(size_t)qg * D + d];
        acc = fmaf(v, v, acc);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s.qn[ql] = acc;
  }
  __syncthreads();

  const int qgrp = warp >> 1;       // queries qgrp*8 .. qgrp*8+7
  const int rhalf = warp & 1;       // rows rhalf*128 + lane + 32*i
  const bool grp_live = q_base + qgrp * 8 < Q;

  for (int tile = row_begin; tile < row_end; tile += TN) {
    float acc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][i] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      // database stage: a warp reads 4 rows x 128 contiguous bytes
      float4 buf[8];
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int idx = it * THREADS + tid;
        const int r = idx >> 3, c = (idx & 7) * 4;
        const int row = tile + r;
        buf[it] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < row_end && d0 + c < D)
          buf[it] = *reinterpret_cast<const float4*>(db + (size_t)row * D + d0 + c);
      }
      // query stage, stored transposed for broadcast reads
      {
        const int ql = tid >> 3, c = (tid & 7) * 4;
        const int qg = q_base + ql;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qg < Q && d0 + c < D)
          v = *reinterpret_cast<const float4*>(q + (size_t)qg * D + d0 + c);
        s.qs[(c + 0) * QT + ql] = v.x;
        s.qs[(c + 1) * QT + ql] = v.y;
        s.qs[(c + 2) * QT + ql] = v.z;
        s.qs[(c + 3) * QT + ql] = v.w;
      }
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int idx = it * THREADS + tid;
        const int r = idx >> 3, c = (idx & 7) * 4;
        float* dst = s.ds + r * DKP + c;
        dst[0] = buf[it].x;
        dst[1] = buf[it].y;
        dst[2] = buf[it].z;
        dst[3] = buf[it].w;
      }
      __syncthreads();
      if (grp_live) {
#pragma unroll 4
        for (int dk = 0; dk < DK; ++dk) {
          const float4 qa = *reinterpret_cast<const float4*>(s.qs + dk * QT + qgrp * 8);
          const float4 qb = *reinterpret_cast<const float4*>(s.qs + dk * QT + qgrp * 8 + 4);
          const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
          float dv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dv[i] = s.ds[(rhalf * 128 + lane + 32 * i) * DKP + dk];
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[a][i] = fmaf(qv[a], dv[i], acc[a][i]);
        }
      }
      __syncthreads();
    }

    // scores tile [QT][TN] over the (now free) database stage
    float* sc = s.ds;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = rhalf * 128 + lane + 32 * i;
      const int row = tile + col;
      const bool ok = row < row_end && valid[row];
      const float sqn = (ok && l2sq) ? sq[row] : 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int ql = qgrp * 8 + a;
        float v = acc[a][i];
        if (l2sq) v = 2.f * v - s.qn[ql] - sqn;
        sc[ql * TN + col] = ok ? v : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // fold: warp w owns queries 4w..4w+3; rows are visited in ascending
    // order (i outer, lanes ascending), so equal scores keep the lower slot
    for (int j = 0; j < 4; ++j) {
      const int ql = warp * 4 + j;
      if (q_base + ql >= Q) break;
      float* lv = s.lv + ql * k;
      int* li = s.li + ql * k;
      float thr = lv[k - 1];
      for (int i = 0; i < TN / 32; ++i) {
        const float v = sc[ql * TN + 32 * i + lane];
        unsigned m = __ballot_sync(0xffffffffu, v > thr);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cv = __shfl_sync(0xffffffffu, v, src);
          if (cv > thr) {
            if (lane == 0) {
              int p = k - 1;
              while (p > 0 && lv[p - 1] < cv) {
                lv[p] = lv[p - 1];
                li[p] = li[p - 1];
                --p;
              }
              lv[p] = cv;
              li[p] = tile + 32 * i + src;
            }
            __syncwarp();
            thr = lv[k - 1];
          }
        }
      }
    }
    __syncthreads();
  }

  // partials [split][Q][k]
  for (int i = tid; i < QT * k; i += THREADS) {
    const int ql = i / k;
    const int qg = q_base + ql;
    if (qg < Q) {
      const size_t o = ((size_t)split * Q + qg) * k + (i % k);
      part_v[o] = s.lv[i];
      part_i[o] = s.li[i];
    }
  }
}

__global__ void __launch_bounds__(32)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int Q, int splits, int kp, int k, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = splits * kp;
  float* cv = reinterpret_cast<float*>(smem_raw);
  int* ci = reinterpret_cast<int*>(cv + C);
  const int qg = blockIdx.x;
  const int lane = threadIdx.x;
  // position p = split*kp + j: in split order, so position order is slot
  // order among equal values
  for (int p = lane; p < C; p += 32) {
    const size_t o = ((size_t)(p / kp) * Q + qg) * kp + (p % kp);
    cv[p] = part_v[o];
    ci[p] = part_i[o];
  }
  __syncwarp();
  for (int r = 0; r < k; ++r) {
    float bv = -CUDART_INF_F;
    int bp = 0x7fffffff;
    for (int p = lane; p < C; p += 32) {
      const float v = cv[p];
      if (v > bv || (v == bv && p < bp)) {
        bv = v;
        bp = p;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (ov > bv || (ov == bv && op < bp)) {
        bv = ov;
        bp = op;
      }
    }
    if (lane == 0) {
      out_v[(size_t)qg * k + r] = bv;
      out_i[(size_t)qg * k + r] = ci[bp];
      cv[bp] = -CUDART_INF_F;
    }
    __syncwarp();
  }
}

size_t partial_smem_bytes(int k) {
  return sizeof(float) * (TN * DKP + DK * QT + QT) + (sizeof(float) + sizeof(int)) * QT * k;
}

}  // namespace

extern "C" {

int fused_knn_k_max() { return K_MAX; }
int fused_knn_qt() { return QT; }
int fused_knn_tn() { return TN; }

// All pointers are device pointers; `stream` is a cudaStream_t. Returns
// the launch's cudaError_t (0 on success).
int fused_knn_partial(const float* q, const float* db, const unsigned char* valid,
                      const float* sq, int Q, int N, int D, int k, int l2sq,
                      int rows_per_split, int splits, float* part_v, int* part_i,
                      void* stream) {
  if (k < 1 || k > K_MAX || D % 4 || rows_per_split % TN) return (int)cudaErrorInvalidValue;
  const size_t smem = partial_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + QT - 1) / QT, splits);
  partial_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, db, valid, sq, Q, N, D, k, l2sq, rows_per_split, part_v, part_i);
  return (int)cudaGetLastError();
}

// Merges [splits, Q, kp] partials into the k <= kp best per query.
int fused_knn_merge(const float* part_v, const int* part_i, int Q, int splits, int kp,
                    int k, float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kp || splits < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (sizeof(float) + sizeof(int)) * (size_t)splits * kp;
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<Q, 32, smem, (cudaStream_t)stream>>>(part_v, part_i, Q, splits, kp,
                                                      k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
