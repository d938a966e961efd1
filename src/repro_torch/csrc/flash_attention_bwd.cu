// K8 flash_bwd: the backward of K7 (causal / sliding-window GQA attention)
// for Hopper (sm_90a): dq, dk and dv from q, k, v, the forward's output o,
// its per-row logsumexp lse and the output's gradient do.
//
// Replaces the Pallas TPU kernels repro/kernels/flash_attention.py::flash_bwd
// (_dq_kernel and _dkv_kernel). Those walked sequential grids and carried
// their f32 accumulators in VMEM scratch along the innermost grid axis
// (key blocks for dq; query blocks times the group's heads for dk/dv), and
// needed S to be a multiple of their blocks. Here each block owns its
// accumulators in registers and loops itself, over the causal/window band
// only, and the ragged tail is masked, so any S works:
//
// * dq kernel: one block per (query head, 64-query tile), 4 warps of 16
//   rows. Q and dO stay in shared memory; for each key tile of the band it
//   stages K and V, recomputes S = Q K^T and p = exp(S * scale - lse) from
//   the forward's lse, forms dP = dO V^T and dS = p (dP - D) scale, and adds
//   dS K into the dq accumulator.
// * dkv kernel: one block per (KV head, 64-key tile), 4 warps of 16 keys
//   (8 warps at D = 256, each then holding half of the columns: a [16, 256]
//   f32 dk + dv accumulator is 256 registers a thread). K and V stay in
//   shared memory; for each of the g query heads of the group, in order, and
//   each query tile of the band it stages Q, dO, lse and D, forms the
//   transposed products S^T = K Q^T and dP^T = V dO^T, and adds P^T dO into
//   dv and dS^T Q into dk. GQA is folded inside the block in a fixed order:
//   no atomics, the same bits on every run.
//
// Semantics, as the TPU kernels: D = rowsum(do * o) in f32 (the wrapper
// computes it with a torch reduction; the JAX package computes it outside
// its kernels too); p = exp(s * scale - lse) with s in f32 and 0 where
// masked; ds = p (dp - D) scale in f32; p and ds are rounded to the inputs'
// type (bf16, the tensor cores' operand) before their products, as the TPU
// kernel's astype does; accumulation in f32; outputs in the inputs' type.
// lse is K7's: the natural log of the sum of exp of the *scaled* scores,
// m + log(max(l, 1e-30)), so exp(s * scale - lse) is the forward's
// normalised p.
//
// What bounds it: operations. At minitron-4b's training shape (q/o/do
// [24, 4096, 128], k/v [8, 4096, 128], bf16, causal) the least work is five
// causal products (S, dP, dV, dK, dQ: 2.58e11 flop, 0.26 ms at the 989
// TFLOP/s bf16 tensor-core peak) against 135 MB moved (0.04 ms at 3.35 TB/s).
// The two-kernel split recomputes S and dP in both kernels: seven products.
//
// bf16 runs on the tensor cores with K7's pieces (flash_common.cuh):
// 16-byte cp.async staging of row-major tiles, ldmatrix (.trans for an
// operand that runs along the product's k axis) and mma.sync.m16n8k16. The
// S and dP accumulators' layout is the A operand's, so p and ds go from
// registers to the next product without touching shared memory. f32 inputs
// take FMA kernels (TF32 would not keep f32's precision): dq with 16 queries
// a block, one key of a 32-key tile a lane; dk/dv with 16 keys a block,
// one query of a 32-query tile a lane. No multi-stage pipeline, TMA or
// wgmma yet.
#include <math.h>

#include "flash_common.cuh"

namespace {

// a (query, key) pair inside the sequence and the band; the forward never
// writes rows past s, so a padded query must not reach dk or dv
__device__ __forceinline__ bool visible_bwd(int qi, int kj, int s, int causal,
                                            int window) {
  return qi < s && visible(qi, kj, s, causal, window);
}

// the query tiles [t0, t1) whose queries see a key of [k0, k1)
__device__ __forceinline__ void query_tiles(int k0, int k1, int s, int bq,
                                            int causal, int window, int* t0,
                                            int* t1) {
  const int qlo = causal ? k0 : 0;
  const int qhi = window > 0 ? min(s, k1 - 1 + window) : s;
  *t0 = qlo / bq;
  *t1 = qhi > qlo ? (qhi + bq - 1) / bq : *t0;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTile = 64;    // queries and keys a tile

template <int D>
constexpr size_t mma_smem() {
  return static_cast<size_t>(4 * kTile) * (D + 8) * sizeof(__nv_bfloat16) +
         2 * kTile * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dcap,
                            __nv_bfloat16* __restrict__ dq, int s, int group,
                            int causal, int window, float scale) {
  constexpr int kNt = D / 8;
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile * kStride;
  __nv_bfloat16* ks = dos + kTile * kStride;
  __nv_bfloat16* vs = ks + kTile * kStride;

  // the last query tiles, which visit the most causal key tiles, start first
  const int nq = (s + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bh = blockIdx.y;
  const int64_t qoff = static_cast<int64_t>(bh) * s * D;
  const int64_t kvoff = static_cast<int64_t>(bh / group) * s * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8
  stage_rows<D, kTile>(qs, q + qoff, q0, s);
  stage_rows<D, kTile>(dos, dout + qoff, q0, s);
  float lse_r[2], dc_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse_r[r] = row < s ? lse[static_cast<int64_t>(bh) * s + row] : 0.f;
    dc_r[r] = row < s ? dcap[static_cast<int64_t>(bh) * s + row] : 0.f;
  }

  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  int t0, t1;
  key_tiles(q0, min(q0 + kTile, s), s, kTile, causal, window, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                        // the last tile's readers are done
    stage_rows<D, kTile>(ks, k + kvoff, k0, s);
    stage_rows<D, kTile>(vs, v + kvoff, k0, s);
    cp_async_wait_all();
    __syncthreads();

    float sc[8][4], dp[8][4];
    warp_abt<D>(sc, qs + warp * 16 * kStride, ks, lane);    // S = Q K^T
    warp_abt<D>(dp, dos + warp * 16 * kStride, vs, lane);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float p =
            visible_bwd(row0 + r * 8, key, s, causal, window)
                ? exp2f((sc[j][e] * scale - lse_r[r]) * kLog2e)
                : 0.f;
        sc[j][e] = p * (dp[j][e] - dc_r[r]) * scale;        // dS
      }
    }
    uint32_t da[4][4];
    to_a_frags(da, sc);
    warp_pb<D, kNt>(acc, da, ks, lane);                     // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= s) continue;
    __nv_bfloat16* out = dq + qoff + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// the dk/dv kernel's warps split the columns kSplit ways (each warp of a
// column part recomputes its keys' S^T and dP^T)
template <int D>
struct DkvSplit {
  static constexpr int kSplit = D > 128 ? 2 : 1;
};

template <int D>
__global__ void __launch_bounds__(kThreads * DkvSplit<D>::kSplit)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dcap,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int s, int group,
                             int causal, int window, float scale) {
  constexpr int kSplit = DkvSplit<D>::kSplit;
  constexpr int kNthreads = kThreads * kSplit;
  constexpr int kCols = D / kSplit;          // dk/dv columns a warp holds
  constexpr int kNt = kCols / 8;
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * kStride;
  __nv_bfloat16* qs = vs + kTile * kStride;
  __nv_bfloat16* dos = qs + kTile * kStride;
  float* lse_s = reinterpret_cast<float*>(dos + kTile * kStride);
  float* dc_s = lse_s + kTile;

  // the first key tiles, which the most causal query tiles see, start first
  const int k0 = static_cast<int>(blockIdx.x) * kTile;
  const int hk = blockIdx.y;
  const int64_t kvoff = static_cast<int64_t>(hk) * s * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3, c0 = (warp >> 2) * kCols;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = k0 + wr * 16 + g;     // this thread's keys: row0, row0+8
  stage_rows<D, kTile, kNthreads>(ks, k + kvoff, k0, s);
  stage_rows<D, kTile, kNthreads>(vs, v + kvoff, k0, s);

  float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.f;
      dv_acc[n][e] = 0.f;
    }
  }
  int t0, t1;
  query_tiles(k0, min(k0 + kTile, s), s, kTile, causal, window, &t0, &t1);
  for (int h = 0; h < group; ++h) {          // the group's query heads
    const int bh = hk * group + h;
    const int64_t qoff = static_cast<int64_t>(bh) * s * D;
    for (int qt = t0; qt < t1; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();                      // the last tile's readers are done
      stage_rows<D, kTile, kNthreads>(qs, q + qoff, q0, s);
      stage_rows<D, kTile, kNthreads>(dos, dout + qoff, q0, s);
      for (int i = threadIdx.x; i < kTile; i += kNthreads) {
        const bool in = q0 + i < s;
        lse_s[i] = in ? lse[static_cast<int64_t>(bh) * s + q0 + i] : 0.f;
        dc_s[i] = in ? dcap[static_cast<int64_t>(bh) * s + q0 + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // P^T = exp(S^T scale - lse), S^T = K Q^T: this warp's 16 keys x 64
      // queries
      float st[8][4];
      warp_abt<D>(st, ks + wr * 16 * kStride, qs, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          st[j][e] = visible_bwd(q0 + c, row0 + (e >> 1) * 8, s, causal,
                                 window)
                         ? exp2f((st[j][e] * scale - lse_s[c]) * kLog2e)
                         : 0.f;
        }
      }
      uint32_t pa[4][4];
      to_a_frags(pa, st);
      warp_pb<D, kNt>(dv_acc, pa, dos + c0, lane);         // dV += P^T dO
      float dpt[8][4];
      warp_abt<D>(dpt, vs + wr * 16 * kStride, dos, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          dpt[j][e] = st[j][e] * (dpt[j][e] - dc_s[c]) * scale;   // dS^T
        }
      }
      to_a_frags(pa, dpt);
      warp_pb<D, kNt>(dk_acc, pa, qs + c0, lane);          // dK += dS^T Q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= s) continue;
    const int64_t off = kvoff + static_cast<int64_t>(row) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 with FMAs
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 16;   // queries (dq) or keys (dkv) a block
constexpr int kF32Lanes = 32;  // keys (dq) or queries (dkv) a tile, one a lane
constexpr int kF32Per = kF32Rows / (kThreads / 32);   // rows a warp

template <int D>
constexpr size_t f32_smem() {
  return (2 * static_cast<size_t>(kF32Rows) * D +
          2 * static_cast<size_t>(kF32Lanes) * (D + 1)) *
         sizeof(float);
}

// rows [r0, r0 + kRows) of a [s, D] f32 matrix into shared memory with row
// stride kLd; rows past s are zero
template <int D, int kRows, int kLd>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int r0, int s) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * kLd + c] =
        r0 + r < s ? src[static_cast<int64_t>(r0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dcap,
                            float* __restrict__ dq, int s, int group,
                            int causal, int window, float scale) {
  constexpr int kPer = (D + 31) / 32;       // output columns a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [rows][D]
  float* dos = qs + kF32Rows * D;                   // [rows][D]
  float* ks = dos + kF32Rows * D;                   // [lanes][D + 1]
  float* vs = ks + kF32Lanes * (D + 1);             // [lanes][D + 1]

  const int nq = (s + kF32Rows - 1) / kF32Rows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kF32Rows;
  const int bh = blockIdx.y;
  const int64_t qoff = static_cast<int64_t>(bh) * s * D;
  const int64_t kvoff = static_cast<int64_t>(bh / group) * s * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_f32<D, kF32Rows, D>(qs, q + qoff, q0, s);
  stage_f32<D, kF32Rows, D>(dos, dout + qoff, q0, s);
  float lse_r[kF32Per], dc_r[kF32Per], acc[kF32Per][kPer];
#pragma unroll
  for (int i = 0; i < kF32Per; ++i) {
    const int row = q0 + warp * kF32Per + i;
    lse_r[i] = row < s ? lse[static_cast<int64_t>(bh) * s + row] : 0.f;
    dc_r[i] = row < s ? dcap[static_cast<int64_t>(bh) * s + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[i][c] = 0.f;
  }
  int t0, t1;
  key_tiles(q0, min(q0 + kF32Rows, s), s, kF32Lanes, causal, window, &t0,
            &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kF32Lanes;
    __syncthreads();
    stage_f32<D, kF32Lanes, D + 1>(ks, k + kvoff, k0, s);
    stage_f32<D, kF32Lanes, D + 1>(vs, v + kvoff, k0, s);
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kF32Per; ++i) {
      const int qr = warp * kF32Per + i;
      float sdot = 0.f, pdot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        sdot = fmaf(qs[qr * D + d], ks[lane * (D + 1) + d], sdot);
        pdot = fmaf(dos[qr * D + d], vs[lane * (D + 1) + d], pdot);
      }
      const float p = visible_bwd(q0 + qr, key, s, causal, window)
                          ? expf(sdot * scale - lse_r[i])
                          : 0.f;
      const float ds = p * (pdot - dc_r[i]) * scale;
      for (int j = 0; j < kF32Lanes; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[i][c] = fmaf(dsj, ks[j * (D + 1) + d], acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kF32Per; ++i) {
    const int row = q0 + warp * kF32Per + i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[qoff + static_cast<int64_t>(row) * D + d] = acc[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dcap,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int s, int group, int causal, int window,
                             float scale) {
  constexpr int kPer = (D + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // [rows][D]
  float* vs = ks + kF32Rows * D;                    // [rows][D]
  float* qs = vs + kF32Rows * D;                    // [lanes][D + 1]
  float* dos = qs + kF32Lanes * (D + 1);            // [lanes][D + 1]

  const int k0 = static_cast<int>(blockIdx.x) * kF32Rows;
  const int hk = blockIdx.y;
  const int64_t kvoff = static_cast<int64_t>(hk) * s * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_f32<D, kF32Rows, D>(ks, k + kvoff, k0, s);
  stage_f32<D, kF32Rows, D>(vs, v + kvoff, k0, s);
  float dk_acc[kF32Per][kPer], dv_acc[kF32Per][kPer];
#pragma unroll
  for (int i = 0; i < kF32Per; ++i) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }
  }
  int t0, t1;
  query_tiles(k0, min(k0 + kF32Rows, s), s, kF32Lanes, causal, window, &t0,
              &t1);
  for (int h = 0; h < group; ++h) {
    const int bh = hk * group + h;
    const int64_t qoff = static_cast<int64_t>(bh) * s * D;
    for (int qt = t0; qt < t1; ++qt) {
      const int q0 = qt * kF32Lanes;
      __syncthreads();
      stage_f32<D, kF32Lanes, D + 1>(qs, q + qoff, q0, s);
      stage_f32<D, kF32Lanes, D + 1>(dos, dout + qoff, q0, s);
      __syncthreads();
      const int qi = q0 + lane;
      const float lse_l =
          qi < s ? lse[static_cast<int64_t>(bh) * s + qi] : 0.f;
      const float dc_l =
          qi < s ? dcap[static_cast<int64_t>(bh) * s + qi] : 0.f;
#pragma unroll
      for (int i = 0; i < kF32Per; ++i) {
        const int kr = warp * kF32Per + i;
        float sdot = 0.f, pdot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          sdot = fmaf(ks[kr * D + d], qs[lane * (D + 1) + d], sdot);
          pdot = fmaf(vs[kr * D + d], dos[lane * (D + 1) + d], pdot);
        }
        const float p = visible_bwd(qi, k0 + kr, s, causal, window)
                            ? expf(sdot * scale - lse_l)
                            : 0.f;
        const float ds = p * (pdot - dc_l) * scale;
        for (int j = 0; j < kF32Lanes; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int c = 0; c < kPer; ++c) {
            const int d = lane + 32 * c;
            if (d < D) {
              dv_acc[i][c] = fmaf(pj, dos[j * (D + 1) + d], dv_acc[i][c]);
              dk_acc[i][c] = fmaf(dsj, qs[j * (D + 1) + d], dk_acc[i][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kF32Per; ++i) {
    const int row = k0 + warp * kF32Per + i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[kvoff + static_cast<int64_t>(row) * D + d] = dk_acc[i][c];
        dv[kvoff + static_cast<int64_t>(row) * D + d] = dv_acc[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *dcap;
  int s, group, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_dq(int dtype, const Args& a, long long bh, void* dq) {
  if (dtype == 2) {
    constexpr size_t smem = mma_smem<D>();
    const int rc = set_smem(flash_bwd_dq_mma_kernel<D>, smem);
    if (rc != 0) return rc;
    const dim3 grid((a.s + kTile - 1) / kTile, static_cast<unsigned>(bh));
    flash_bwd_dq_mma_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dcap),
        static_cast<__nv_bfloat16*>(dq), a.s, a.group, a.causal, a.window,
        a.scale);
  } else if (dtype == 0) {
    constexpr size_t smem = f32_smem<D>();
    const int rc = set_smem(flash_bwd_dq_f32_kernel<D>, smem);
    if (rc != 0) return rc;
    const dim3 grid((a.s + kF32Rows - 1) / kF32Rows,
                    static_cast<unsigned>(bh));
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dcap),
        static_cast<float*>(dq), a.s, a.group, a.causal, a.window, a.scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(int dtype, const Args& a, long long bkv, void* dk, void* dv) {
  if (dtype == 2) {
    constexpr size_t smem = mma_smem<D>();
    const int rc = set_smem(flash_bwd_dkv_mma_kernel<D>, smem);
    if (rc != 0) return rc;
    const dim3 grid((a.s + kTile - 1) / kTile, static_cast<unsigned>(bkv));
    flash_bwd_dkv_mma_kernel<D>
        <<<grid, kThreads * DkvSplit<D>::kSplit, smem, a.stream>>>(
            static_cast<const __nv_bfloat16*>(a.q),
            static_cast<const __nv_bfloat16*>(a.k),
            static_cast<const __nv_bfloat16*>(a.v),
            static_cast<const __nv_bfloat16*>(a.dout),
            static_cast<const float*>(a.lse),
            static_cast<const float*>(a.dcap),
            static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
            a.s, a.group, a.causal, a.window, a.scale);
  } else if (dtype == 0) {
    constexpr size_t smem = f32_smem<D>();
    const int rc = set_smem(flash_bwd_dkv_f32_kernel<D>, smem);
    if (rc != 0) return rc;
    const dim3 grid((a.s + kF32Rows - 1) / kF32Rows,
                    static_cast<unsigned>(bkv));
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dcap),
        static_cast<float*>(dk), static_cast<float*>(dv), a.s, a.group,
        a.causal, a.window, a.scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the checks both entry points make; fills a and returns 0, or an error
int prepare(Args* a, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* dcap,
            long long bh, long long bkv, int s, int d, int causal,
            int window, void* stream) {
  if (bkv <= 0 || bh % bkv != 0 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *a = Args{q, k, v, dout, lse, dcap, s, static_cast<int>(bh / bkv),
            causal, window,
            static_cast<float>(1.0 / sqrt(static_cast<double>(d))),
            static_cast<cudaStream_t>(stream)};
  return 0;
}

}  // namespace

#define REPRO_FLASH_BWD_DISPATCH(CALL)                            \
  switch (d) {                                                    \
    case 16: return CALL(16);                                     \
    case 32: return CALL(32);                                     \
    case 64: return CALL(64);                                     \
    case 96: return CALL(96);                                     \
    case 128: return CALL(128);                                   \
    case 256: return CALL(256);                                   \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

// q, o, do [bh, s, d]; k, v [bkv, s, d]; lse and dcap = rowsum(do * o)
// [bh, s] f32; dq [bh, s, d]; dk, dv [bkv, s, d]; all contiguous. dtype:
// 0 = float32, 2 = bfloat16 (q, k, v, do and the outputs share it).
// window <= 0: no window. d in {16, 32, 64, 96, 128, 256}.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* dcap, void* dq, int dtype,
                                  long long bh, long long bkv, int s, int d,
                                  int causal, int window, void* stream) {
  Args a;
  const int rc = prepare(&a, q, k, v, dout, lse, dcap, bh, bkv, s, d,
                         causal, window, stream);
  if (rc != 0) return rc;
  if (bh == 0 || s == 0) return static_cast<int>(cudaGetLastError());
#define REPRO_DQ(D) launch_dq<D>(dtype, a, bh, dq)
  REPRO_FLASH_BWD_DISPATCH(REPRO_DQ)
#undef REPRO_DQ
}

extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dcap,
                                   void* dk, void* dv, int dtype,
                                   long long bh, long long bkv, int s, int d,
                                   int causal, int window, void* stream) {
  Args a;
  const int rc = prepare(&a, q, k, v, dout, lse, dcap, bh, bkv, s, d,
                         causal, window, stream);
  if (rc != 0) return rc;
  if (bh == 0 || s == 0) return static_cast<int>(cudaGetLastError());
#define REPRO_DKV(D) launch_dkv<D>(dtype, a, bkv, dk, dv)
  REPRO_FLASH_BWD_DISPATCH(REPRO_DKV)
#undef REPRO_DKV
}
