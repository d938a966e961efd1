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
// * dq kernel: one block per (query head, query tile). Q and dO stay in
//   shared memory; for each key tile of the band it brings in K and V,
//   recomputes S = Q K^T and p = exp(S * scale - lse) from the forward's
//   lse, forms dP = dO V^T and dS = p (dP - D) scale, and adds dS K into the
//   dq accumulator.
// * dkv kernel: one block per (KV head, key tile). K and V stay in shared
//   memory; for each of the g query heads of the group, in order, and each
//   query tile of the band it brings in Q, dO, lse and D, forms the
//   transposed products S^T = K Q^T and dP^T = V dO^T, and adds P^T dO into
//   dv and dS^T Q into dk. GQA is folded inside the block in a fixed order:
//   no atomics, the same bits on every run.
//
// Semantics, as the TPU kernels: D = rowsum(do * o) in f32 (a small kernel
// that the dq entry point launches first; the JAX package computes it
// outside its kernels); p = exp(s * scale - lse) with s in f32 and 0 where
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
// The two-kernel split recomputes S and dP in the dq kernel: seven products.
//
// bf16 at D = 128 (the LM's training shape) runs on Hopper's warpgroup
// products (hopper_common.cuh), each kernel fed by a ring of two stages of
// TMA tile loads that complete on mbarriers: while a warpgroup computes on
// one stage, the next tile is in flight into the other, and one thread
// refills a stage once every reader is done with it. Operands sit in
// 128-byte-swizzled shared memory; S and dP run shared-memory x
// shared-memory (m64n64k16), and p and ds go from the accumulators'
// registers straight into the next products as the register A operand
// (m64n128k16, the streamed tile read MN-major).
//
// * dk/dv: one block per (KV head, 64-key tile), one warpgroup (two
//   blocks an SM), K and V resident, the group's query heads and the band's
//   64-query tiles streamed (Q, dO and the tile's lse and D); dk and dv (64
//   + 64 f32 a thread) and S^T, dP^T (32 + 32) stay under the register
//   limit. The first key tiles of every head, which the most causal query
//   tiles see, start first.
// * dq: one block per (query head, 64-query tile), one warpgroup, Q and dO
//   resident and K, V streamed. dq recomputes S and dP rather than taking
//   dS from the dk/dv kernel: handing dS over would need either f32 atomics
//   into dq (an order that changes from run to run) or a per-(head, query
//   tile) counter that makes the key tiles add in turn (FA3's deterministic
//   mode), a cross-block protocol left for later. Seven products, no
//   atomics, the same bits on every run.
//
// bf16 at the other D keeps the mma.sync kernels (K7's pieces from
// flash_common.cuh: 16-byte cp.async staging of row-major tiles, ldmatrix,
// mma.sync.m16n8k16, one stage, no overlap of copies with products); the
// dq kernel there has one block per (query head, 64-query tile) and the
// dk/dv kernel one per (KV head, 64-key tile), 8 warps at D = 256, each
// holding half of the columns (a [16, 256] f32 dk + dv accumulator is 256
// registers a thread). f32 inputs take FMA kernels (TF32 would not keep
// f32's precision): dq with 16 queries a block, one key of a 32-key tile a
// lane; dk/dv with 16 keys a block, one query of a 32-query tile a lane.
// The wrapper pads lse and D to whole 64-query tiles (row stride ls).
#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

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
                            __nv_bfloat16* __restrict__ dq, int s, int ls,
                            int group, int causal, int window,
                            float scale) {
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
    lse_r[r] = row < s ? lse[static_cast<int64_t>(bh) * ls + row] : 0.f;
    dc_r[r] = row < s ? dcap[static_cast<int64_t>(bh) * ls + row] : 0.f;
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
                             __nv_bfloat16* __restrict__ dv, int s, int ls,
                             int group, int causal, int window, float scale) {
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
        lse_s[i] = in ? lse[static_cast<int64_t>(bh) * ls + q0 + i] : 0.f;
        dc_s[i] = in ? dcap[static_cast<int64_t>(bh) * ls + q0 + i] : 0.f;
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
                            float* __restrict__ dq, int s, int ls, int group,
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
    lse_r[i] = row < s ? lse[static_cast<int64_t>(bh) * ls + row] : 0.f;
    dc_r[i] = row < s ? dcap[static_cast<int64_t>(bh) * ls + row] : 0.f;
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
                             int s, int ls, int group, int causal, int window,
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
          qi < s ? lse[static_cast<int64_t>(bh) * ls + qi] : 0.f;
      const float dc_l =
          qi < s ? dcap[static_cast<int64_t>(bh) * ls + qi] : 0.f;
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
// bf16 at D = 128 on wgmma, with a TMA copy ring
// ---------------------------------------------------------------------------

namespace wg {

using hopper::wg::aligned_smem;
using hopper::wg::kD;
using hopper::wg::kmajor;
using hopper::wg::kTile;
using hopper::wg::kTileBytes;
using hopper::wg::load_rows;
using hopper::wg::mnmajor;

// ---- dk/dv: one block per (KV head, 64-key tile), one warpgroup

constexpr int kDkvThreads = 128;
constexpr int kDkvStages = 2;            // the copy ring of Q, dO, lse, D
constexpr int kDkvStage = 2 * kTileBytes + 2 * kTile * 4 + 512;   // 33 KB
constexpr size_t kDkvSmem = 1024 + 2 * kTileBytes + kDkvStages * kDkvStage +
                            64;

__global__ void __launch_bounds__(kDkvThreads, 2)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ dcap,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int s, int ls, int group, int causal, int window,
               float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  unsigned char* ks = base;                               // [64, 128]
  unsigned char* vs = ks + kTileBytes;                    // [64, 128]
  unsigned char* ring = vs + kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kDkvStages * kDkvStage);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks start in the order of their index, heads fastest: the first key
  // tiles of every head, which the most causal query tiles see, go first
  const int k0 = static_cast<int>(blockIdx.y) * kTile;
  const int hk = blockIdx.x;
  int t0, t1;
  query_tiles(k0, min(k0 + kTile, s), s, kTile, causal, window, &t0, &t1);
  const int nqt = t1 - t0;
  const int items = group * nqt;             // (query head, query tile)

  auto issue = [&](int i) {                  // item i into its stage
    unsigned char* st = ring + (i % kDkvStages) * kDkvStage;
    const int bh = hk * group + i / nqt;
    const int q0 = (t0 + i % nqt) * kTile;
    uint64_t* bar = full + i % kDkvStages;
    hopper::mbar_expect_tx(bar, 2 * kTileBytes + 2 * kTile * 4);
    load_rows(st, &tq, bar, q0, bh);
    load_rows(st + kTileBytes, &tdo, bar, q0, bh);
    const int64_t off = static_cast<int64_t>(bh) * ls + q0;
    hopper::bulk_load(st + 2 * kTileBytes, lse + off, kTile * 4, bar);
    hopper::bulk_load(st + 2 * kTileBytes + kTile * 4, dcap + off, kTile * 4,
                      bar);
  };

  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int i = 0; i < kDkvStages; ++i) hopper::mbar_init(full + i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_bar, 2 * kTileBytes);
    load_rows(ks, &tk, kv_bar, k0, hk);
    load_rows(vs, &tv, kv_bar, k0, hk);
    for (int i = 0; i < min(kDkvStages, items); ++i) issue(i);
  }

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const int krow = k0 + warp * 16 + g;      // keys krow, krow + 8
  hopper::mbar_wait(kv_bar, 0);
  for (int i = 0; i < items; ++i) {
    const unsigned char* st = ring + (i % kDkvStages) * kDkvStage;
    const unsigned char* qs = st;
    const unsigned char* dos = st + kTileBytes;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * kTileBytes);
    const float* dc_s = lse_s + kTile;
    const int q0 = (t0 + i % nqt) * kTile;
    hopper::mbar_wait(full + i % kDkvStages, (i / kDkvStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = 0.f;
      dp[e] = 0.f;
    }
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      hopper::wgmma_m64n64k16_ss(sc, kmajor(ks, kk), kmajor(qs, kk), 1);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      hopper::wgmma_m64n64k16_ss(dp, kmajor(vs, kk), kmajor(dos, kk), 1);
    }
    hopper::wgmma_commit();

    // P^T = exp(S^T scale - lse), while dP^T is still on the tensor cores;
    // a tile the band covers whole needs no mask
    const bool whole = q0 + kTile <= s && k0 + kTile <= s &&
                       (!causal || k0 + kTile - 1 <= q0) &&
                       (window <= 0 || q0 + kTile - 1 - window < k0);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const int x = 4 * j + e;
        const bool in =
            whole ||
            visible_bwd(q0 + c, krow + (e >> 1) * 8, s, causal, window);
        sc[x] = in ? exp2f((sc[x] * scale - lse_s[c]) * kLog2e) : 0.f;
      }
    }
    uint32_t pa[4][4], da[4][4];
    hopper::acc_to_a(pa, sc);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);

    // dV += P^T dO (the queries along k), and dS^T = P^T (dP^T - D) scale
    // while it runs; then dK += dS^T Q
    hopper::fence_regs(pa);
    hopper::fence_regs(dv_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      hopper::wgmma_m64n128k16_rs_tb(dv_acc, pa[kk], mnmajor(dos, kk), 1);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        dp[x] = sc[x] * (dp[x] - dc_s[j * 8 + 2 * t + (e & 1)]) * scale;
      }
    }
    hopper::acc_to_a(da, dp);
    hopper::fence_regs(da);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      hopper::wgmma_m64n128k16_rs_tb(dk_acc, da[kk], mnmajor(qs, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);

    __syncthreads();                         // the stage's readers are done
    if (tid == 0 && i + kDkvStages < items) issue(i + kDkvStages);
  }

  const int64_t kvoff = static_cast<int64_t>(hk) * s * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + r * 8;
    if (row >= s) continue;
    const int64_t off = kvoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
          pack_bf16(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
          pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---- dq: one block per (query head, 64-query tile), one warpgroup

constexpr int kDqThreads = 128;
constexpr int kDqStages = 2;             // the copy ring of K, V
constexpr size_t kDqSmem = 1024 + 2 * kTileBytes + kDqStages * 2 * kTileBytes +
                           64;

__global__ void __launch_bounds__(kDqThreads)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ dcap,
              __nv_bfloat16* __restrict__ dq, int s, int ls, int group,
              int causal, int window, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  unsigned char* qs = base;                               // [64, 128]
  unsigned char* dos = qs + kTileBytes;                   // [64, 128]
  unsigned char* ring = dos + kTileBytes;                 // K, V a stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kDqStages * 2 *
                                               kTileBytes);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // heads fastest: the last query tiles of every head, which visit the
  // most causal key tiles, start first
  const int nq = (s + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int bh = blockIdx.x;
  const int hk = bh / group;
  int t0, t1;
  key_tiles(q0, min(q0 + kTile, s), s, kTile, causal, window, &t0, &t1);
  const int items = t1 - t0;

  auto issue = [&](int i) {
    unsigned char* st = ring + (i % kDqStages) * 2 * kTileBytes;
    uint64_t* bar = full + i % kDqStages;
    const int k0 = (t0 + i) * kTile;
    hopper::mbar_expect_tx(bar, 2 * kTileBytes);
    load_rows(st, &tk, bar, k0, hk);
    load_rows(st + kTileBytes, &tv, bar, k0, hk);
  };

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int i = 0; i < kDqStages; ++i) hopper::mbar_init(full + i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_bar, 2 * kTileBytes);
    load_rows(qs, &tq, q_bar, q0, bh);
    load_rows(dos, &tdo, q_bar, q0, bh);
    for (int i = 0; i < min(kDqStages, items); ++i) issue(i);
  }

  const int qrow = q0 + warp * 16 + g;       // queries qrow, qrow + 8
  float lse_r[2], dc_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t off = static_cast<int64_t>(bh) * ls + qrow + r * 8;
    lse_r[r] = lse[off];                     // rows up to ls exist
    dc_r[r] = dcap[off];
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  for (int i = 0; i < items; ++i) {
    const unsigned char* ks = ring + (i % kDqStages) * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
    const int k0 = (t0 + i) * kTile;
    hopper::mbar_wait(full + i % kDqStages, (i / kDqStages) & 1);

    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = 0.f;
      dp[e] = 0.f;
    }
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {      // S = Q K^T
      hopper::wgmma_m64n64k16_ss(sc, kmajor(qs, kk), kmajor(ks, kk), 1);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {      // dP = dO V^T
      hopper::wgmma_m64n64k16_ss(dp, kmajor(dos, kk), kmajor(vs, kk), 1);
    }
    hopper::wgmma_commit();

    // p, while dP is still on the tensor cores; a tile the band covers
    // whole needs no mask
    const bool whole = q0 + kTile <= s && k0 + kTile <= s &&
                       (!causal || k0 + kTile - 1 <= q0) &&
                       (window <= 0 || q0 + kTile - 1 - window < k0);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int x = 4 * j + e;
        const bool in = whole || visible_bwd(qrow + r * 8,
                                             k0 + j * 8 + 2 * t + (e & 1), s,
                                             causal, window);
        sc[x] = in ? exp2f((sc[x] * scale - lse_r[r]) * kLog2e) : 0.f;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        dp[x] = sc[x] * (dp[x] - dc_r[e >> 1]) * scale;   // dS
      }
    }
    uint32_t da[4][4];
    hopper::acc_to_a(da, dp);
    hopper::fence_regs(da);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {   // dQ += dS K
      hopper::wgmma_m64n128k16_rs_tb(acc, da[kk], mnmajor(ks, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(da);

    __syncthreads();
    if (tid == 0 && i + kDqStages < items) issue(i + kDqStages);
  }

  const int64_t qoff = static_cast<int64_t>(bh) * s * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + r * 8;
    if (row >= s) continue;
    __nv_bfloat16* out = dq + qoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// the four tensor maps of one call: q and do over [bh, s, 128], k and v
// over [bkv, s, 128], boxes of 64 rows
struct Maps {
  CUtensorMap q, k, v, dout;
};

inline int make_maps(Maps* m, const void* q, const void* k, const void* v,
                     const void* dout, long long bh, long long bkv, int s) {
  int rc = hopper::tensor_map_bf16(&m->q, q, kD, s, bh, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&m->k, k, kD, s, bkv, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&m->v, v, kD, s, bkv, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&m->dout, dout, kD, s, bh, kTile);
  return rc;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// D = rowsum(do * o)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one warp a row of the [bh, ls] f32 output: rows below s get the f32 sum
// of o * do over D, the padding rows [s, ls) get 0 (the dk/dv kernels copy
// whole tiles of it; a masked query's p is 0, and its D must be finite)
template <typename T>
__global__ void flash_bwd_dcap_kernel(const T* __restrict__ o,
                                      const T* __restrict__ dout,
                                      float* __restrict__ dcap, int s, int ls,
                                      int d) {
  const int lane = threadIdx.x & 31;
  const int row = static_cast<int>(blockIdx.x) * (kThreads / 32) +
                  (threadIdx.x >> 5);
  if (row >= ls) return;
  const int64_t bh = blockIdx.y;
  float acc = 0.f;
  if (row < s) {
    const int64_t off = (bh * s + row) * d;
    for (int c = lane; c < d; c += 32) {
      acc = fmaf(as_f32(o[off + c]), as_f32(dout[off + c]), acc);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  }
  if (lane == 0) dcap[bh * ls + row] = acc;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *dcap;
  int s, ls, group, causal, window;
  float scale;
  cudaStream_t stream;
};

// bf16 at D = 128 takes the wgmma kernels, bf16 at every other D the
// mma.sync kernels, f32 the FMA kernels
template <int D>
int launch_dq(int dtype, const Args& a, long long bh, void* dq) {
  if (dtype == 2) {
    if constexpr (D == wg::kD) {
      wg::Maps m;
      int rc = wg::make_maps(&m, a.q, a.k, a.v, a.dout, bh,
                             bh / a.group, a.s);
      if (rc == 0) rc = set_smem(wg::flash_bwd_dq_wgmma_kernel, wg::kDqSmem);
      if (rc != 0) return rc;
      const dim3 grid(static_cast<unsigned>(bh),
                      (a.s + wg::kTile - 1) / wg::kTile);
      wg::flash_bwd_dq_wgmma_kernel<<<grid, wg::kDqThreads, wg::kDqSmem,
                                      a.stream>>>(
          m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.dcap), static_cast<__nv_bfloat16*>(dq),
          a.s, a.ls, a.group, a.causal, a.window, a.scale);
      return static_cast<int>(cudaGetLastError());
    } else {
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
          static_cast<__nv_bfloat16*>(dq), a.s, a.ls, a.group, a.causal,
          a.window, a.scale);
    }
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
        static_cast<float*>(dq), a.s, a.ls, a.group, a.causal, a.window,
        a.scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(int dtype, const Args& a, long long bkv, void* dk, void* dv) {
  if (dtype == 2) {
    if constexpr (D == wg::kD) {
      wg::Maps m;
      int rc = wg::make_maps(&m, a.q, a.k, a.v, a.dout, bkv * a.group, bkv,
                             a.s);
      if (rc == 0) rc = set_smem(wg::flash_bwd_dkv_wgmma_kernel, wg::kDkvSmem);
      if (rc != 0) return rc;
      const dim3 grid(static_cast<unsigned>(bkv),
                      (a.s + wg::kTile - 1) / wg::kTile);
      wg::flash_bwd_dkv_wgmma_kernel<<<grid, wg::kDkvThreads, wg::kDkvSmem,
                                       a.stream>>>(
          m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.dcap), static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), a.s, a.ls, a.group, a.causal,
          a.window, a.scale);
      return static_cast<int>(cudaGetLastError());
    } else {
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
              a.s, a.ls, a.group, a.causal, a.window, a.scale);
    }
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
        static_cast<float*>(dk), static_cast<float*>(dv), a.s, a.ls, a.group,
        a.causal, a.window, a.scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the checks both entry points make; fills a and returns 0, or an error
int prepare(Args* a, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* dcap,
            long long bh, long long bkv, int s, int d, int ls, int causal,
            int window, void* stream) {
  if (bkv <= 0 || bh % bkv != 0 || bh > 65535 || ls < s || ls % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *a = Args{q, k, v, dout, lse, dcap, s, ls, static_cast<int>(bh / bkv),
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
// [bh, ls] f32 (rows padded to ls, a multiple of 64, ls >= s; dcap written
// by repro_flash_bwd_dq); dq [bh, s, d]; dk, dv [bkv, s, d]; all contiguous
// and 16-byte aligned. dtype: 0 =
// float32, 2 = bfloat16 (q, k, v, do and the outputs share it). window <=
// 0: no window. d in {16, 32, 64, 96, 128, 256}.
// The dq entry point first writes dcap = rowsum(do * o) from o (the
// forward's output, q's type), then launches the dq kernel; the dk/dv entry
// point reads that dcap, so it runs after this one on the same stream.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* dcap, void* dq,
                                  int dtype, long long bh, long long bkv,
                                  int s, int d, int ls, int causal,
                                  int window, void* stream) {
  Args a;
  const int rc = prepare(&a, q, k, v, dout, lse, dcap, bh, bkv, s, d, ls,
                         causal, window, stream);
  if (rc != 0) return rc;
  if (bh == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  const dim3 dgrid((ls + kThreads / 32 - 1) / (kThreads / 32),
                   static_cast<unsigned>(bh));
  if (dtype == 2) {
    flash_bwd_dcap_kernel<<<dgrid, kThreads, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(dcap),
        s, ls, d);
  } else if (dtype == 0) {
    flash_bwd_dcap_kernel<<<dgrid, kThreads, 0, a.stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(dcap), s, ls, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define REPRO_DQ(D) launch_dq<D>(dtype, a, bh, dq)
  REPRO_FLASH_BWD_DISPATCH(REPRO_DQ)
#undef REPRO_DQ
}

extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dcap,
                                   void* dk, void* dv, int dtype,
                                   long long bh, long long bkv, int s, int d,
                                   int ls, int causal, int window,
                                   void* stream) {
  Args a;
  const int rc = prepare(&a, q, k, v, dout, lse, dcap, bh, bkv, s, d, ls,
                         causal, window, stream);
  if (rc != 0) return rc;
  if (bh == 0 || s == 0) return static_cast<int>(cudaGetLastError());
#define REPRO_DKV(D) launch_dkv<D>(dtype, a, bkv, dk, dv)
  REPRO_FLASH_BWD_DISPATCH(REPRO_DKV)
#undef REPRO_DKV
}
