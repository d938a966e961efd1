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
// that the dq entry point launches first, or at D = 64 in bf16 the dq
// kernel itself; the JAX package computes it outside its kernels); p =
// exp(s * scale - lse) with s in f32 and 0 where masked; ds = p (dp - D)
// scale in f32; p and ds are rounded to the inputs' type (bf16, the tensor
// cores' operand) before their products, as the TPU kernel's astype does;
// accumulation in f32; outputs in the inputs' type.
// lse is K7's: the natural log of the sum of exp of the *scaled* scores,
// m + log(max(l, 1e-30)), so exp(s * scale - lse) is the forward's
// normalised p.
//
// What bounds it: operations. At minitron-4b's training shape (q/o/do
// [24, 4096, 128], k/v [8, 4096, 128], bf16, causal) the least work is five
// causal products (S, dP, dV, dK, dQ: 2.58e11 flop, 0.26 ms at the 989
// TFLOP/s bf16 tensor-core peak) against 135 MB moved (0.04 ms at 3.35 TB/s);
// at recurrentgemma-9b's (q/o/do [16, 4096, 256], k/v [1, 4096, 256],
// window 2048) five products of the band, 2.58e11 flop (0.2606 ms), against
// 143 MB (0.04 ms). The two-kernel split recomputes S and dP in the dq
// kernel: seven products. At granite-moe-3b-a800m's (q/o/do [24, 4096,
// 64], k/v [8, 4096, 64], causal) the five products are 1.29e11 flop
// (0.130 ms) and each kernel's p another 2.0e8 ex2 (~0.048 ms on the
// special-function units), as much as a third of its products' time.
//
// bf16 at D = 64, 128 and 256 runs on Hopper's warpgroup products
// (hopper_common.cuh), each kernel fed by a ring of TMA tile loads that
// complete on mbarriers: while a warpgroup computes on one stage, the next
// tile is in flight into another. Operands sit in 128-byte-swizzled shared
// memory; S and dP run shared-memory x shared-memory, and p and ds go from
// the accumulators' registers straight into the next products as the
// register A operand (the streamed tile read MN-major).
//
// At D = 128 one warpgroup a block; one thread refills a stage once every
// reader is done with it:
// * dk/dv: one block per (KV head, 64-key tile), two blocks an SM, K and V
//   resident, the group's query heads and the band's 64-query tiles
//   streamed (Q, dO and the tile's lse and D); dk and dv (64 + 64 f32 a
//   thread) and S^T, dP^T (32 + 32) stay under the register limit. The
//   first key tiles of every head, which the most causal query tiles see,
//   start first.
// * dq: one block per (query head, 64-query tile), Q and dO resident and K,
//   V streamed. dq recomputes S and dP rather than taking dS from the dk/dv
//   kernel: handing dS over would need either f32 atomics into dq (an order
//   that changes from run to run) or a per-(head, query tile) counter that
//   makes the key tiles add in turn (FA3's deterministic mode), a
//   cross-block protocol left for later. Seven products, no atomics, the
//   same bits on every run.
//
// At D = 256 (recurrentgemma's local attention) a [64, 256] f32 accumulator
// is 128 registers a thread, so a block has two consumer warpgroups and a
// producer warpgroup that keeps the TMA ring full and refills a stage once
// all 256 consumer threads have released it (an empty mbarrier); launched
// at 168 registers a thread, the producer drops to 24 and the consumers
// rise to 240 (setmaxnreg). One block an SM:
// * dk/dv (211 KB of shared memory): K and V of 64 keys resident; the
//   ring's two stages hold a (query head, 64-query tile) item's Q, dO, lse
//   and D. dk and dv cannot share a warpgroup (256 registers), so
//   warpgroup 0 forms S^T and the f32 P^T, hands P^T over through 16 KB of
//   shared memory (two named barriers) and adds dV += P^T dO; warpgroup 1
//   forms dP^T, dS^T from that P^T, and adds dK += dS^T Q. Software-
//   pipelined: each warpgroup queues the next item's first product behind
//   this item's second. recurrentgemma has one KV head, so S / 64 blocks
//   would leave half of the 132 SMs idle: the grid splits each GQA group's
//   query heads `splits` ways (the wrapper's dkv_splits, from the SM count:
//   8 at S 4096), each block writes f32 partial dk, dv into a workspace, and
//   a reduce kernel sums the splits in split order into bf16 (no atomics;
//   the same bits on every run of one card model).
// * dq (225 KB): two query heads of a GQA group, one a consumer warpgroup,
//   each with its Q and dO resident, share the band's 64-key K and V
//   tiles, streamed through separate rings (K two stages, V one, released
//   as soon as dP is done); S and dP as SS m64n64k16, dQ += dS K as RS
//   m64n256k16.
//
// At D = 64 (granite's attention) each consumer warpgroup owns 64 rows of
// a block, a producer warpgroup streams the other operands through a
// 4-stage TMA ring (24 registers, setmaxnreg), and one warpgroup's
// exponentials run under the others' products:
// * dk/dv: one block per (KV head, 128-key tile), two consumer warpgroups
//   (240 registers a thread); a warpgroup keeps its K and V in registers
//   (the A operands of S^T and dP^T) and its dK, dV accumulators (32 + 32
//   f32); the items, (64-query tile, query head) in that order, stream Q,
//   dO, lse and D. No grid split: 256 blocks at granite's shape.
// * dq: one block per (query head, 192-query tile), three consumer
//   warpgroups (160 registers a thread) with their Q and dO tiles in shared
//   memory; a warpgroup computes D = rowsum(do * o) of its rows itself (and
//   writes it for dk/dv, so no D kernel runs), and the band's 64-key K and
//   V tiles stream.
// At D = 64 with sk <= 512 (an encoder's self-attention, a cross-attention
// over an encoder's output) both take a short form, for grids that fill
// the card (seamless-m4t-large-v2 at batch 1: 16 heads over 512 keys; the
// long forms ran 64 dk/dv blocks for 132 SMs and 352 dq blocks in 2.67
// waves at its cross-attention, 48 dq blocks at its encoder):
// * dk/dv: a cluster of `splits` blocks (the wrapper's dkv_splits, from the
//   SM count: 2 at seamless's shapes) shares a (KV head, 128-key tile);
//   each walks a contiguous run of its items and keeps its f32 dK, dV in
//   shared memory, and each writes 128 / splits of the keys, summing the
//   splits' partials in split order through distributed shared memory.
// * dq: one block per (query head, part of its 64-query tiles), the head's
//   K and V resident whole (eight 64-key tiles, 128 KB, loaded once a
//   part), the three warpgroups walking the part's 64-query items, each
//   the long form's walk (dq and D keep their bits).
//   Ruled out: one fused pass with all 512 keys resident (a block's dK and
//   dV for 512 keys are 256 KB of f32, the SM's whole register file), and
//   dQ added with f32 atomics from the dk/dv walk (an order of adds that
//   changes from run to run).
// ptxas serialises wgmma products it cannot prove safe to overlap (its
// C7514-C7520 notes): a branch on the warpgroup's index, read from
// threadIdx, counts as divergent unless the index comes through a shuffle
// from lane 0, and an accumulator that plain instructions write or read
// while a product is in flight counts too; so the first k step of each
// product writes its accumulator (scale-d false, an output-only asm) and
// a warpgroup waits for all its products before its elementwise work.
//
// bf16 at D 16, 32 and 96 keeps the mma.sync kernels (K7's pieces from
// flash_common.cuh: 16-byte cp.async staging of row-major tiles, ldmatrix,
// mma.sync.m16n8k16, one stage, no overlap of copies with products); the
// dq kernel there has one block per (query head, 64-query tile) and the
// dk/dv kernel one per (KV head, 64-key tile), 4 warps. f32 inputs take FMA
// kernels (TF32 would not keep f32's precision): dq with 16 queries a
// block, one key of a 32-key tile a lane; dk/dv with 16 keys a block, one
// query of a 32-query tile a lane.
// The wrapper pads lse and D to whole 64-query tiles (row stride ls).
#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

// a (query row, key) pair inside the s queries, the sk keys and the band
// (query row qi at position qi + qp, as K7's visible); the forward never
// writes rows past s, so a padded query must not reach dk or dv
__device__ __forceinline__ bool visible_bwd(int qi, int kj, int s, int sk,
                                            int causal, int window, int qp) {
  return qi < s && visible(qi + qp, kj, sk, causal, window);
}

// the tiles [t0, t1) of s query rows whose queries see a key of [k0, k1);
// none for keys past every query's position (t0 = t1), whose dk and dv are
// then 0
__device__ __forceinline__ void query_tiles(int k0, int k1, int s, int bq,
                                            int causal, int window, int qp,
                                            int* t0, int* t1) {
  const int qlo = causal ? max(0, k0 - qp) : 0;
  const int qhi = window > 0 ? min(s, k1 - 1 + window - qp) : s;
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
                            __nv_bfloat16* __restrict__ dq, int s, int sk,
                            int ls,
                            int group, int causal, int window, int qp,
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
  const int64_t kvoff = static_cast<int64_t>(bh / group) * sk * D;
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
  key_tiles(q0, min(q0 + kTile, s), sk, kTile, causal, window, qp, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                        // the last tile's readers are done
    stage_rows<D, kTile>(ks, k + kvoff, k0, sk);
    stage_rows<D, kTile>(vs, v + kvoff, k0, sk);
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
            visible_bwd(row0 + r * 8, key, s, sk, causal, window, qp)
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dcap,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int s, int sk,
                             int ls,
                             int group, int causal, int window, int qp,
                             float scale) {
  constexpr int kNt = D / 8;
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
  const int64_t kvoff = static_cast<int64_t>(hk) * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = k0 + warp * 16 + g;   // this thread's keys: row0, row0+8
  stage_rows<D, kTile>(ks, k + kvoff, k0, sk);
  stage_rows<D, kTile>(vs, v + kvoff, k0, sk);

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
  query_tiles(k0, min(k0 + kTile, sk), s, kTile, causal, window, qp, &t0, &t1);
  for (int h = 0; h < group; ++h) {          // the group's query heads
    const int bh = hk * group + h;
    const int64_t qoff = static_cast<int64_t>(bh) * s * D;
    for (int qt = t0; qt < t1; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();                      // the last tile's readers are done
      stage_rows<D, kTile>(qs, q + qoff, q0, s);
      stage_rows<D, kTile>(dos, dout + qoff, q0, s);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const bool in = q0 + i < s;
        lse_s[i] = in ? lse[static_cast<int64_t>(bh) * ls + q0 + i] : 0.f;
        dc_s[i] = in ? dcap[static_cast<int64_t>(bh) * ls + q0 + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // P^T = exp(S^T scale - lse), S^T = K Q^T: this warp's 16 keys x 64
      // queries
      float st[8][4];
      warp_abt<D>(st, ks + warp * 16 * kStride, qs, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          st[j][e] = visible_bwd(q0 + c, row0 + (e >> 1) * 8, s, sk,
                                 causal, window, qp)
                         ? exp2f((st[j][e] * scale - lse_s[c]) * kLog2e)
                         : 0.f;
        }
      }
      uint32_t pa[4][4];
      to_a_frags(pa, st);
      warp_pb<D, kNt>(dv_acc, pa, dos, lane);              // dV += P^T dO
      float dpt[8][4];
      warp_abt<D>(dpt, vs + warp * 16 * kStride, dos, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          dpt[j][e] = st[j][e] * (dpt[j][e] - dc_s[c]) * scale;   // dS^T
        }
      }
      to_a_frags(pa, dpt);
      warp_pb<D, kNt>(dk_acc, pa, qs, lane);               // dK += dS^T Q
    }
  }
  cp_async_wait_all();      // keys no query sees: K, V land before the exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= sk) continue;
    const int64_t off = kvoff + static_cast<int64_t>(row) * D + 2 * t;
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
                            float* __restrict__ dq, int s, int sk, int ls,
                            int group,
                            int causal, int window, int qp, float scale) {
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
  const int64_t kvoff = static_cast<int64_t>(bh / group) * sk * D;
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
  key_tiles(q0, min(q0 + kF32Rows, s), sk, kF32Lanes, causal, window, qp, &t0,
            &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kF32Lanes;
    __syncthreads();
    stage_f32<D, kF32Lanes, D + 1>(ks, k + kvoff, k0, sk);
    stage_f32<D, kF32Lanes, D + 1>(vs, v + kvoff, k0, sk);
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
      const float p = visible_bwd(q0 + qr, key, s, sk, causal, window, qp)
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
                             int s, int sk, int ls, int group, int causal,
                             int window, int qp, float scale) {
  constexpr int kPer = (D + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // [rows][D]
  float* vs = ks + kF32Rows * D;                    // [rows][D]
  float* qs = vs + kF32Rows * D;                    // [lanes][D + 1]
  float* dos = qs + kF32Lanes * (D + 1);            // [lanes][D + 1]

  const int k0 = static_cast<int>(blockIdx.x) * kF32Rows;
  const int hk = blockIdx.y;
  const int64_t kvoff = static_cast<int64_t>(hk) * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_f32<D, kF32Rows, D>(ks, k + kvoff, k0, sk);
  stage_f32<D, kF32Rows, D>(vs, v + kvoff, k0, sk);
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
  query_tiles(k0, min(k0 + kF32Rows, sk), s, kF32Lanes, causal, window, qp, &t0,
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
        const float p = visible_bwd(qi, k0 + kr, s, sk, causal, window, qp)
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
    if (row >= sk) continue;
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
               int s, int sk, int ls, int group, int causal, int window,
               int qp, float scale) {
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
  query_tiles(k0, min(k0 + kTile, sk), s, kTile, causal, window, qp, &t0, &t1);
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
    const bool whole = q0 + kTile <= s && k0 + kTile <= sk &&
                       (!causal || k0 + kTile - 1 <= q0 + qp) &&
                       (window <= 0 || q0 + qp + kTile - 1 - window < k0);
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
            visible_bwd(q0 + c, krow + (e >> 1) * 8, s, sk, causal,
                        window, qp);
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

  const int64_t kvoff = static_cast<int64_t>(hk) * sk * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + r * 8;
    if (row >= sk) continue;
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
              __nv_bfloat16* __restrict__ dq, int s, int sk, int ls, int group,
              int causal, int window, int qp, float scale) {
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
  key_tiles(q0, min(q0 + kTile, s), sk, kTile, causal, window, qp, &t0, &t1);
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
    const bool whole = q0 + kTile <= s && k0 + kTile <= sk &&
                       (!causal || k0 + kTile - 1 <= q0 + qp) &&
                       (window <= 0 || q0 + qp + kTile - 1 - window < k0);
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
                                             sk, causal, window, qp);
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

// the four tensor maps of one call: q and do over [bh, s, d], k and v
// over [bkv, sk, d], boxes of 64 rows (d 64, 128 or 256)
struct Maps {
  CUtensorMap q, k, v, dout;
};

inline int make_maps(Maps* m, const void* q, const void* k, const void* v,
                     const void* dout, long long bh, long long bkv, int s,
                     int sk, int d = kD) {
  int rc = hopper::tensor_map_bf16(&m->q, q, d, s, bh, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&m->k, k, d, sk, bkv, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&m->v, v, d, sk, bkv, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&m->dout, dout, d, s, bh, kTile);
  return rc;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16 at D = 256 on wgmma: two consumer warpgroups and a producer
// ---------------------------------------------------------------------------

namespace wg256 {

using hopper::ex2;
using hopper::wg::aligned_shared;
using hopper::wg::kmajor;
using hopper::wg::kTile;
using hopper::wg::load_rows;
using hopper::wg::mnmajor;

constexpr int kH = 4;                               // 64-column halves
constexpr int kD = 64 * kH;
constexpr int kTileBytes = hopper::wg::tile_bytes<kH>();   // [64, 256]: 32 KB
constexpr int kConsumers = 256;                     // two warpgroups
constexpr int kThreads256 = kConsumers + 128;       // and the producer
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// ---- dk/dv: one block per (64-key tile, KV head, split of its group)

constexpr int kDkvStages = 2;            // the copy ring of Q, dO, lse, D
// Q, dO, then lse and D (64 f32 each), padded so that every stage's tiles
// start on a 1024-byte boundary
constexpr int kDkvStage = 2 * kTileBytes + 1024;
constexpr int kPBytes = 32 * kConsumers / 2 * 4;    // P^T, f32: 16 KB
constexpr size_t kDkvSmem = 1024 + 2 * kTileBytes + kDkvStages * kDkvStage +
                            kPBytes + 64;           // 211 KB
constexpr int kPFull = 1, kPEmpty = 2;              // named barriers

// K and V of the block's 64 keys stay resident; the producer streams
// (query head, 64-query tile) items of the band through the ring. dk and dv
// do not fit one warpgroup (2 x 128 f32 a thread), so each warpgroup owns
// one: warpgroup 0 forms S^T = K Q^T and P^T = exp(S^T scale - lse), hands
// the f32 P^T to warpgroup 1 through shared memory (coalesced: element x of
// thread c at x * 128 + c) and adds dV += P^T dO; warpgroup 1 forms dP^T =
// V dO^T, then dS^T = P^T (dP^T - D) scale from that f32 P^T, and adds
// dK += dS^T Q. Four products, two a warpgroup, each accumulator 128
// registers. The group's query heads [hb, he) of the block's split are
// walked in order; with splits > 1 the block writes its f32 partial dk, dv
// into the workspace ws [2, splits, bkv, s, 256] and the split reduce sums
// them in split order, so the bits never depend on block timing.
__global__ void __launch_bounds__(kThreads256, 1)
    flash_bwd_dkv_wgmma256_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ dcap,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ ws, int s, int sk, int ls, int group,
               int splits,
               int causal, int window, int qp, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = aligned_shared(smem_raw);     // [64, 256]
  unsigned char* vs = ks + kTileBytes;              // [64, 256]
  unsigned char* ring = vs + kTileBytes;
  float* pbuf = reinterpret_cast<float*>(ring + kDkvStages * kDkvStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(pbuf) + kPBytes);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kDkvStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // (head, split) fastest: the first key tiles, which the most causal query
  // tiles see, start first
  const int k0 = static_cast<int>(blockIdx.y) * kTile;
  const int hk = static_cast<int>(blockIdx.x) / splits;
  const int split = static_cast<int>(blockIdx.x) % splits;
  const int hb = split * group / splits, he = (split + 1) * group / splits;
  int t0, t1;
  query_tiles(k0, min(k0 + kTile, sk), s, kTile, causal, window, qp, &t0, &t1);
  const int nqt = t1 - t0;
  const int items = (he - hb) * nqt;        // (query head, query tile)

  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int i = 0; i < kDkvStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {             // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      hopper::mbar_expect_tx(kv_bar, 2 * kTileBytes);
      load_rows<kH>(ks, &tk, kv_bar, k0, hk);
      load_rows<kH>(vs, &tv, kv_bar, k0, hk);
      for (int i = 0; i < items; ++i) {
        const int st = i % kDkvStages;
        if (i >= kDkvStages) {
          hopper::mbar_wait(empty + st, (i / kDkvStages - 1) & 1);
        }
        unsigned char* stage = ring + st * kDkvStage;
        const int bh = hk * group + hb + i / nqt;
        const int q0 = (t0 + i % nqt) * kTile;
        hopper::mbar_expect_tx(full + st, 2 * kTileBytes + 2 * kTile * 4);
        load_rows<kH>(stage, &tq, full + st, q0, bh);
        load_rows<kH>(stage + kTileBytes, &tdo, full + st, q0, bh);
        const int64_t off = static_cast<int64_t>(bh) * ls + q0;
        hopper::bulk_load(stage + 2 * kTileBytes, lse + off, kTile * 4,
                          full + st);
        hopper::bulk_load(stage + 2 * kTileBytes + kTile * 4, dcap + off,
                          kTile * 4, full + st);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  const int wgi = warp >> 2;      // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int ctid = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int krow = k0 + (warp & 3) * 16 + g;        // keys krow, krow + 8
  const unsigned char* a_res = wgi == 0 ? ks : vs;  // the resident A
  const float scale_log2 = scale * kLog2e;

  // the stage of item i: Q, dO, lse, D
  auto stage = [&](int i) { return ring + (i % kDkvStages) * kDkvStage; };
  // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1) of item i:
  // 64 keys x 64 queries, issued once the item's stage has landed
  float sc[32];
  auto first_product = [&](int i) {
    const unsigned char* qs = stage(i);
    const unsigned char* b_st = wgi == 0 ? qs : qs + kTileBytes;
    hopper::mbar_wait(full + i % kDkvStages, (i / kDkvStages) & 1);
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      hopper::wgmma_m64n64k16_ss(sc, kmajor(a_res, kk), kmajor(b_st, kk), 1);
    }
    hopper::wgmma_commit();
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  hopper::mbar_wait(kv_bar, 0);
  if (items > 0) first_product(0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  // software-pipelined: item i's second product (dV or dK) is issued, then
  // item i + 1's first product behind it, so each warpgroup keeps the
  // tensor cores fed while it waits, and the elementwise work of item i + 1
  // starts as soon as its own product is done
  for (int i = 0; i < items; ++i) {
    const unsigned char* qs = stage(i);
    const unsigned char* dos = qs + kTileBytes;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * kTileBytes);
    const float* dc_s = lse_s + kTile;
    const int q0 = (t0 + i % nqt) * kTile;

    if (wgi == 0) {
      // P^T = exp(S^T scale - lse) = 2^(s c - lse log2e), c = scale
      // log2e, then 0 where masked (no branch); a tile the band covers
      // whole needs no mask
      const bool whole = q0 + kTile <= s && k0 + kTile <= sk &&
                         (!causal || k0 + kTile - 1 <= q0 + qp) &&
                         (window <= 0 || q0 + qp + kTile - 1 - window < k0);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = (x >> 2) * 8 + 2 * t + (x & 1);
        const bool in = whole | visible_bwd(q0 + c, krow + ((x >> 1) & 1) * 8,
                                            s, sk, causal, window, qp);
        const float p = ex2(fmaf(sc[x], scale_log2, -lse_s[c] * kLog2e));
        sc[x] = in ? p : 0.f;
      }
      if (i > 0) hopper::named_sync(kPEmpty, kConsumers);   // last P^T read
#pragma unroll
      for (int x = 0; x < 32; ++x) pbuf[x * 128 + ctid] = sc[x];
      hopper::named_arrive(kPFull, kConsumers);
    } else {
      // dS^T = P^T (dP^T - D) scale, from warpgroup 0's f32 P^T
      hopper::named_sync(kPFull, kConsumers);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = (x >> 2) * 8 + 2 * t + (x & 1);
        sc[x] = pbuf[x * 128 + ctid] * (sc[x] - dc_s[c]) * scale;
      }
      if (i + 1 < items) hopper::named_arrive(kPEmpty, kConsumers);
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): the queries
    // along k, the streamed tile read MN-major
    const unsigned char* b_acc = wgi == 0 ? dos : qs;
    uint32_t pa[4][4];
    hopper::acc_to_a(pa, sc);
    hopper::fence_regs(pa);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      hopper::wgmma_m64n256k16_rs_tb(acc, pa[kk], mnmajor(b_acc, kk), 1);
    }
    hopper::wgmma_commit();
    if (i + 1 < items) {
      first_product(i + 1);
      hopper::wgmma_wait<1>();              // item i's second product
    } else {
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    hopper::mbar_arrive(empty + i % kDkvStages);    // item i's stage is read
    hopper::wgmma_wait<0>();                // item i + 1's first product
    hopper::fence_regs(sc);
  }

  const int bkv = static_cast<int>(gridDim.x) / splits;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + r * 8;
    if (row >= sk) continue;
    const int64_t off =
        (static_cast<int64_t>(hk) * sk + row) * kD + 2 * t;
    if (splits == 1) {
      __nv_bfloat16* out = (wgi == 0 ? dv : dk) + off;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        *reinterpret_cast<uint32_t*>(out + j * 8) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    } else {
      // ws [2, splits, bkv, s, 256]: dk's partials first
      float* out = ws + (static_cast<int64_t>(1 - wgi) * splits + split) *
                            bkv * sk * kD + off;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        *reinterpret_cast<float2*>(out + j * 8) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dk, dv = the sum of ws [2, splits, n] over splits, in split order, as bf16
__global__ void flash_bwd_split_reduce_kernel(const float* __restrict__ ws,
                                              __nv_bfloat16* __restrict__ dk,
                                              __nv_bfloat16* __restrict__ dv,
                                              long long n, int splits) {
  const int which = blockIdx.y;                     // 0: dk, 1: dv
  const float4* src = reinterpret_cast<const float4*>(ws) +
                      static_cast<int64_t>(which) * splits * (n / 4);
  uint2* dst = reinterpret_cast<uint2*>(which == 0 ? dk : dv);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n / 4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 a = src[i];
    for (int j = 1; j < splits; ++j) {
      const float4 b = src[static_cast<int64_t>(j) * (n / 4) + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    dst[i] = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
}

// ---- dq: one block per (KV head, pair of its query heads, 64-query tile)

constexpr int kDqKStages = 2;                       // the copy ring of K
constexpr int kDqVStages = 1;                       // and of V
constexpr size_t kDqSmem = 1024 + 4 * kTileBytes +
                           (kDqKStages + kDqVStages) * kTileBytes +
                           64;                      // 225 KB

// As the forward: the pair's two heads walk the same key band, each
// consumer warpgroup keeps its head's Q and dO resident and the producer
// streams the band's 64-key K and V tiles. Four resident tiles leave room
// for three more, so K and V take separate rings: V, which only dP reads,
// is released as soon as both warpgroups' dP is done and gets one stage; K,
// which dQ reads too, gets two. Per tile, S = Q K^T and dP = dO V^T (SS
// m64n64k16, 16 k steps each), dS = p (dP - D) scale, dQ += dS K (RS
// m64n256k16, K read MN-major). dq recomputes S and dP rather than taking
// dS from the dk/dv kernel: no atomics, the same bits on every run.
__global__ void __launch_bounds__(kThreads256, 1)
    flash_bwd_dq_wgmma256_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ dcap,
              __nv_bfloat16* __restrict__ dq, int s, int sk, int ls, int group,
              int pairs, int causal, int window, int qp,
              float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = aligned_shared(smem_raw);     // Q of each warpgroup
  unsigned char* dos = qs + 2 * kTileBytes;         // dO of each warpgroup
  unsigned char* kring = dos + 2 * kTileBytes;      // K a stage
  unsigned char* vring = kring + kDqKStages * kTileBytes;   // V
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vring +
                                                kDqVStages * kTileBytes);
  uint64_t* kempty = kfull + kDqKStages;
  uint64_t* vfull = kempty + kDqKStages;
  uint64_t* vempty = vfull + kDqVStages;
  uint64_t* q_bar = vempty + kDqVStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nq = (s + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int hk = static_cast<int>(blockIdx.x) / pairs;
  const int h0 = 2 * (static_cast<int>(blockIdx.x) % pairs);
  const int nheads = min(2, group - h0);
  int t0, t1;
  key_tiles(q0, min(q0 + kTile, s), sk, kTile, causal, window, qp, &t0, &t1);
  const int items = t1 - t0;

  if (tid == 0) {
    for (int i = 0; i < kDqKStages; ++i) {
      hopper::mbar_init(kfull + i, 1);
      hopper::mbar_init(kempty + i, kConsumers);
    }
    for (int i = 0; i < kDqVStages; ++i) {
      hopper::mbar_init(vfull + i, 1);
      hopper::mbar_init(vempty + i, kConsumers);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {             // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      hopper::mbar_expect_tx(q_bar, nheads * 2 * kTileBytes);
      for (int c = 0; c < nheads; ++c) {
        const int bh = hk * group + h0 + c;
        load_rows<kH>(qs + c * kTileBytes, &tq, q_bar, q0, bh);
        load_rows<kH>(dos + c * kTileBytes, &tdo, q_bar, q0, bh);
      }
      for (int i = 0; i < items; ++i) {
        const int k0 = (t0 + i) * kTile;
        const int ks = i % kDqKStages, vst = i % kDqVStages;
        if (i >= kDqKStages) {
          hopper::mbar_wait(kempty + ks, (i / kDqKStages - 1) & 1);
        }
        hopper::mbar_expect_tx(kfull + ks, kTileBytes);
        load_rows<kH>(kring + ks * kTileBytes, &tk, kfull + ks, k0, hk);
        if (i >= kDqVStages) {
          hopper::mbar_wait(vempty + vst, (i / kDqVStages - 1) & 1);
        }
        hopper::mbar_expect_tx(vfull + vst, kTileBytes);
        load_rows<kH>(vring + vst * kTileBytes, &tv, vfull + vst, k0, hk);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  const int wgi = warp >> 2;                        // this warpgroup's head
  const bool active = wgi < nheads;
  const int bh = hk * group + h0 + wgi;
  const unsigned char* qt = qs + wgi * kTileBytes;
  const unsigned char* dot = dos + wgi * kTileBytes;
  const int g = lane >> 2, t = lane & 3;
  const int qrow = q0 + (warp & 3) * 16 + g;        // queries qrow, qrow + 8
  // the keys [lo, hi] each of this thread's two rows sees (visible_bwd:
  // none for a row past s)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    hi[r] = row >= s ? -1 : causal ? row + qp : sk - 1;
    lo[r] = window > 0 ? row + qp - window + 1 : 0;
  }
  const float scale_log2 = scale * kLog2e;
  float lse_l[2] = {0.f, 0.f}, dc_r[2] = {0.f, 0.f};   // lse log2e, D
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t off = static_cast<int64_t>(bh) * ls + qrow + r * 8;
      lse_l[r] = lse[off] * kLog2e;                 // rows up to ls exist
      dc_r[r] = dcap[off];
    }
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  hopper::mbar_wait(q_bar, 0);
  for (int i = 0; i < items; ++i) {
    const int ks = i % kDqKStages, vst = i % kDqVStages;
    const unsigned char* kt = kring + ks * kTileBytes;
    const unsigned char* vt = vring + vst * kTileBytes;
    const int k0 = (t0 + i) * kTile;
    hopper::mbar_wait(kfull + ks, (i / kDqKStages) & 1);
    hopper::mbar_wait(vfull + vst, (i / kDqVStages) & 1);
    if (!active) {                // an odd group's idle half paces the rings
      hopper::mbar_arrive(vempty + vst);
      hopper::mbar_arrive(kempty + ks);
      continue;
    }
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
    for (int kk = 0; kk < kD / 16; ++kk) {          // S = Q K^T
      hopper::wgmma_m64n64k16_ss(sc, kmajor(qt, kk), kmajor(kt, kk), 1);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {          // dP = dO V^T
      hopper::wgmma_m64n64k16_ss(dp, kmajor(dot, kk), kmajor(vt, kk), 1);
    }
    hopper::wgmma_commit();

    // p, while dP is still on the tensor cores; a tile the band covers
    // whole needs no mask
    const bool whole = q0 + kTile <= s && k0 + kTile <= sk &&
                       (!causal || k0 + kTile - 1 <= q0 + qp) &&
                       (window <= 0 || q0 + qp + kTile - 1 - window < k0);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      const int key = k0 + (x >> 2) * 8 + 2 * t + (x & 1);
      const bool in = whole | ((key >= lo[r]) & (key <= hi[r]));
      const float p = ex2(fmaf(sc[x], scale_log2, -lse_l[r]));
      sc[x] = in ? p : 0.f;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    hopper::mbar_arrive(vempty + vst);              // V is read
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      dp[x] = sc[x] * (dp[x] - dc_r[(x >> 1) & 1]) * scale;   // dS
    }
    uint32_t da[4][4];
    hopper::acc_to_a(da, dp);
    hopper::fence_regs(da);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {       // dQ += dS K
      hopper::wgmma_m64n256k16_rs_tb(acc, da[kk], mnmajor(kt, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    hopper::mbar_arrive(kempty + ks);               // K is read
  }
  if (!active) return;

  const int64_t qoff = static_cast<int64_t>(bh) * s * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + r * 8;
    if (row >= s) continue;
    __nv_bfloat16* out = dq + qoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

}  // namespace wg256

// ---------------------------------------------------------------------------
// bf16 at D = 64 on wgmma: two consumer warpgroups and a producer
// ---------------------------------------------------------------------------

namespace wg64 {

using hopper::ex2;
using hopper::wg::aligned_shared;
using hopper::wg::kmajor;
using hopper::wg::load_rows;
using hopper::wg::mnmajor;

constexpr int kD = 64;
constexpr int kTileBytes = hopper::wg::tile_bytes<1>();   // [64, 64]: 8 KB
constexpr int kBlock = 128;            // keys a dk/dv block
constexpr int kConsumers = 256;        // dk/dv's two consumer warpgroups
constexpr int kThreads64 = kConsumers + 128;        // and the producer
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// ---- dk/dv: one block per (128-key tile, KV head)

constexpr int kDkvStages = 4;            // the copy ring of Q, dO, lse, D
// Q, dO, then lse and D (64 f32 each), padded so that every stage's tiles
// start on a 1024-byte boundary
constexpr int kDkvStage = 2 * kTileBytes + 1024;
constexpr size_t kDkvSmem = 1024 + kDkvStages * kDkvStage + 64;   // 69 KB
// the short form (sk <= kShortKeys, flash_attention.py's SHORT_KEYS):
// every 64-key tile of a head fits in the dq kernel's shared memory, and the
// dk/dv kernel splits each block's items over a cluster of up to the
// portable cluster size, each split's f32 dK, dV in shared memory beside
// the ring for the cluster's blocks to add
constexpr int kShortKeys = 512;
constexpr int kShortTiles = kShortKeys / kTile;     // 8 64-key tiles
constexpr int kMaxSplits = 8;
// a split's f32 dK, dV of a key: 64 each and 4 of padding after each, so
// that the eight rows a warp writes at once fall on distinct banks
constexpr int kPartLd = kD + 4;
constexpr int kPartKey = 2 * kPartLd;
constexpr size_t kDkvSplitSmem =
    kDkvSmem + kBlock * kPartKey * sizeof(float);           // 137 KB

// Each consumer warpgroup owns 64 of the block's keys: its K and V stay in
// registers as the A operands of S^T = K Q^T and dP^T = V dO^T (64 keys x
// 64 queries, 4 k steps over D each), and its dK and dV accumulators (32 +
// 32 f32 a thread) with them; that takes about 200 of the 240 registers,
// so a block has two consumer warpgroups, not three. The producer streams
// the band's (64-query tile, query head) items, tile by tile and the
// group's heads in order within a tile, through the ring; both warpgroups
// read each item. Per item: S^T and dP^T, waited for with the item
// before's dV and dK, then P^T = exp(S^T scale - lse), dS^T = P^T (dP^T -
// D) scale, and dV += P^T dO, dK += dS^T Q (dO and Q read MN-major) with
// the next item's S^T and dP^T queued behind them; the other warpgroup's
// products run under one's elementwise work. A warpgroup walks only the
// items its keys see (a prefix or a suffix of the block's) and releases
// the others untouched. The order of the adds is fixed: no atomics, the
// same bits on every run.
//
// kSplit, the short form's (sk <= kShortKeys): a grid of (KV head, 128-key
// tile) blocks is a few dozen at an encoder's or a cross-attention's key
// length (seamless: 16 x 4 = 64 blocks for 132 SMs, each walking every
// query tile of the head). So `splits` blocks, one cluster, share a
// (KV head, key tile): block r of the cluster walks the r-th of `splits`
// contiguous runs of the items (query tile, then query head) and keeps its
// f32 dK, dV in shared memory; between two cluster barriers each block then
// writes 128 / splits of the keys, each element the sum of the splits'
// partials in split order, the others' read through distributed shared
// memory. No atomics and no second kernel; a fixed order of adds, the same
// bits on every run (not the long form's bits: a split's sum starts at 0).
template <bool kSplit>
__global__ void __launch_bounds__(kThreads64, 1)
    flash_bwd_dkv_wgmma64_kernel(const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ dcap,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int s, int sk, int ls, int group, int causal, int window,
               int qp, float scale, int splits) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_shared(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDkvStages *
                                               kDkvStage);
  uint64_t* empty = full + kDkvStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // heads fastest: the first key tiles of every head, which the most
  // causal query tiles see, start first
  const int k0 = static_cast<int>(blockIdx.y) * kBlock;
  const int split = kSplit ? hopper::cluster_rank() : 0;
  const int hk = kSplit ? static_cast<int>(blockIdx.x) / splits
                        : static_cast<int>(blockIdx.x);
  int t0, t1;
  query_tiles(k0, min(k0 + kBlock, sk), s, kTile, causal, window, qp, &t0, &t1);
  // the block's run [lo, lo + items) of the (query tile, query head) items
  const int all = (t1 - t0) * group;
  const int lo = kSplit ? split * all / splits : 0;
  const int items = kSplit ? (split + 1) * all / splits - lo : all;

  if (tid == 0) {
    for (int i = 0; i < kDkvStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const bool clustered = kSplit && splits > 1;

  if (warp >= kConsumers / 32) {             // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int i = 0; i < items; ++i) {
        const int st = i % kDkvStages;
        if (i >= kDkvStages) {
          hopper::mbar_wait(empty + st, (i / kDkvStages - 1) & 1);
        }
        unsigned char* stage = ring + st * kDkvStage;
        const int bh = hk * group + (lo + i) % group;
        const int q0 = (t0 + (lo + i) / group) * kTile;
        hopper::mbar_expect_tx(full + st, 2 * kTileBytes + 2 * kTile * 4);
        load_rows<1>(stage, &tq, full + st, q0, bh);
        load_rows<1>(stage + kTileBytes, &tdo, full + st, q0, bh);
        const int64_t off = static_cast<int64_t>(bh) * ls + q0;
        hopper::bulk_load(stage + 2 * kTileBytes, lse + off, kTile * 4,
                          full + st);
        hopper::bulk_load(stage + 2 * kTileBytes + kTile * 4, dcap + off,
                          kTile * 4, full + st);
      }
    }
    if (clustered) {                         // the epilogue's two barriers
      hopper::cluster_sync();
      hopper::cluster_sync();
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  // the warpgroup's index, read from lane 0 so that the compiler knows it
  // is the same in every thread of a warp: the branches that depend on it
  // (the warpgroup's range of items, its masks) then do not count as
  // divergent, and ptxas keeps the wgmma products asynchronous rather than
  // serialising them
  const int wgi = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 64 * wgi;                    // this warpgroup's keys
  const int krow = kw0 + (warp & 3) * 16 + g;       // keys krow, krow + 8
  // the block's items [a, b) that this warpgroup's keys see
  int a = 0, b = 0;
  if (kw0 < sk) {
    int w0, w1;
    query_tiles(kw0, min(kw0 + 64, sk), s, kTile, causal, window, qp, &w0, &w1);
    if (w1 > w0) {
      a = (w0 - t0) * group;
      b = (w1 - t0) * group;
    }
  }
  if (kSplit) {                              // within the block's run
    a = min(max(a - lo, 0), items);
    b = min(max(b - lo, 0), items);
  }
  const int64_t kvoff = static_cast<int64_t>(hk) * sk * kD;
  uint32_t ka[4][4], va[4][4];
  hopper::rows_to_a64(ka, k + kvoff, krow, sk, t);
  hopper::rows_to_a64(va, v + kvoff, krow, sk, t);
  const float scale_log2 = scale * kLog2e;

  auto stage = [&](int i) { return ring + (i % kDkvStages) * kDkvStage; };
  auto release = [&](int i) { hopper::mbar_arrive(empty + i % kDkvStages); };
  // S^T = K Q^T and dP^T = V dO^T of item i into sc and dp, two commit
  // groups, issued once the item's stage has landed
  auto first_products = [&](int i, float (&sc)[32], float (&dp)[32]) {
    const unsigned char* qs = stage(i);
    hopper::mbar_wait(full + i % kDkvStages, (i / kDkvStages) & 1);
    hopper::wgmma_fence();
    hopper::wgmma_m64n64k16_rs_z(sc, ka[0], kmajor(qs, 0));
#pragma unroll
    for (int kk = 1; kk < kD / 16; ++kk) {
      hopper::wgmma_m64n64k16_rs(sc, ka[kk], kmajor(qs, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_m64n64k16_rs_z(dp, va[0], kmajor(qs + kTileBytes, 0));
#pragma unroll
    for (int kk = 1; kk < kD / 16; ++kk) {
      hopper::wgmma_m64n64k16_rs(dp, va[kk], kmajor(qs + kTileBytes, kk), 1);
    }
    hopper::wgmma_commit();
  };

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    dk_acc[x] = 0.f;
    dv_acc[x] = 0.f;
  }
  for (int i = 0; i < a; ++i) {              // items only the other sees
    hopper::mbar_wait(full + i % kDkvStages, (i / kDkvStages) & 1);
    release(i);
  }
  uint32_t pa[4][4], da[4][4];
  // item i's S^T, dP^T in sc, dp (and the item before's dV and dK) are
  // done (a partial wait would leave ptxas to serialise the products,
  // since the elementwise work reads their accumulators): the other
  // warpgroup's products run under this one's elementwise work
  auto done = [&](float (&sc)[32], float (&dp)[32]) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
  };
  // item i from its S^T and dP^T: P^T = exp(S^T scale - lse) = 2^(s c -
  // lse log2e), c = scale log2e, 0 where masked (only a tile the band does
  // not cover whole needs the mask), dS^T = P^T (dP^T - D) scale, then dV
  // += P^T dO and dK += dS^T Q (the queries along k, the streamed tiles
  // read MN-major), one commit group
  auto update = [&](int i, float (&sc)[32], float (&dp)[32]) {
    const unsigned char* qs = stage(i);
    const unsigned char* dos = qs + kTileBytes;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * kTileBytes);
    const float* dc_s = lse_s + kTile;
    const int q0 = (t0 + (lo + i) / group) * kTile;
    const bool whole = q0 + kTile <= s && kw0 + 64 <= sk &&
                       (!causal || kw0 + 63 <= q0 + qp) &&
                       (window <= 0 || q0 + qp + kTile - 1 - window < kw0);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int c = (x >> 2) * 8 + 2 * t + (x & 1);
      sc[x] = ex2(fmaf(sc[x], scale_log2, -lse_s[c] * kLog2e));
    }
    if (!whole) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = (x >> 2) * 8 + 2 * t + (x & 1);
        sc[x] = visible_bwd(q0 + c, krow + ((x >> 1) & 1) * 8, s, sk,
                            causal, window, qp)
                    ? sc[x]
                    : 0.f;
      }
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int c = (x >> 2) * 8 + 2 * t + (x & 1);
      dp[x] = sc[x] * (dp[x] - dc_s[c]) * scale;
    }
    hopper::acc_to_a(pa, sc);
    hopper::acc_to_a(da, dp);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      hopper::wgmma_m64n64k16_rs_tb(dv_acc, pa[kk], mnmajor(dos, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      hopper::wgmma_m64n64k16_rs_tb(dk_acc, da[kk], mnmajor(qs, kk), 1);
    }
    hopper::wgmma_commit();
  };
  if constexpr (kSplit) {
    // S^T and dP^T declared in the loop body and issued at its top, behind
    // the item before's dV and dK: issued at the bottom, for the next item,
    // into accumulators the loop carries (the long form's order), they
    // make ptxas serialise every wgmma product of the kernel (its C7515
    // note)
    for (int i = a; i < b; ++i) {
      float sc[32], dp[32];
      first_products(i, sc, dp);
      done(sc, dp);
      if (i > a) release(i - 1);
      update(i, sc, dp);
    }
  } else {
    float sc[32], dp[32];
    if (a < b) first_products(a, sc, dp);
    for (int i = a; i < b; ++i) {
      done(sc, dp);
      if (i > a) release(i - 1);
      update(i, sc, dp);
      if (i + 1 < b) first_products(i + 1, sc, dp);   // behind dV and dK
    }
  }
  if (a < b) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    release(b - 1);
  }
  for (int i = b; i < items; ++i) {
    hopper::mbar_wait(full + i % kDkvStages, (i / kDkvStages) & 1);
    release(i);
  }
  if (clustered) {
    // every split's f32 dK, dV into its shared memory, [key][dK, dV]; each
    // split then writes 128 / splits of the block's keys, each element the
    // sum over the splits in split order, the others' read through
    // distributed shared memory: the same bits whichever split writes,
    // coalesced stores, and the cluster's blocks share the work
    float* part = reinterpret_cast<float*>(ring + kDkvStages * kDkvStage + 64);
    const int kl = krow - k0;                       // the block's key
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* at = part + (kl + 8 * r) * kPartKey + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(at) =
            make_float2(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(at + kPartLd) =
            make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
    hopper::cluster_sync();                         // the partials are written
    const int kn = kBlock / splits;                 // keys a split writes
    for (int idx = tid; idx < kn * 2 * (kD / 4); idx += kConsumers) {
      const int row = idx / (kD / 4);               // [key][dK, dV]
      const int key = split * kn + row / 2, c = (idx % (kD / 4)) * 4;
      const float4* at = reinterpret_cast<const float4*>(
          part + key * kPartKey + (row % 2) * kPartLd + c);
      float4 sum = *hopper::cluster_map(at, 0);
      for (int q = 1; q < splits; ++q) {
        const float4 x = *hopper::cluster_map(at, q);
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      if (k0 + key < sk) {
        __nv_bfloat16* out = (row % 2 == 0 ? dk : dv) + kvoff +
                             static_cast<int64_t>(k0 + key) * kD + c;
        *reinterpret_cast<uint2*>(out) =
            make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
      }
    }
    hopper::cluster_sync();                         // read: the blocks may go
    return;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + r * 8;
    if (row >= sk) continue;
    const int64_t off = kvoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
          pack_bf16(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
          pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// D = rowsum(do * o) of a thread's two rows (queries row0 and row0 + 8 of
// an m64 operand) from its A fragments of dO (a) and o (b): its 16 column
// pairs in a fixed order, then the quad of threads that shares the rows
__device__ __forceinline__ void row_dots(float (&dc)[2],
                                         const uint32_t (&a)[4][4],
                                         const uint32_t (&b)[4][4]) {
  dc[0] = dc[1] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&b[kk][e]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&a[kk][e]));
      dc[e & 1] = fmaf(x.y, y.y, fmaf(x.x, y.x, dc[e & 1]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dc[r] += __shfl_xor_sync(0xffffffffu, dc[r], 1);
    dc[r] += __shfl_xor_sync(0xffffffffu, dc[r], 2);
  }
}

// a warpgroup's dS of one 64-key tile at k0 from its S and dP: p = 2^(s c -
// lse log2e), c = scale log2e, 0 where masked (a row sees the keys [lo,
// hi]; a tile the band covers whole needs no mask), then dS = p (dP - D)
// scale, packed as the register A operand of dQ += dS K
__device__ __forceinline__ void tile_ds(uint32_t (&da)[4][4],
                                        float (&sc)[32], float (&dp)[32],
                                        int k0, bool whole,
                                        const int (&lo)[2], const int (&hi)[2],
                                        const float (&lse_l)[2],
                                        const float (&dc)[2], int t,
                                        float scale_log2, float scale) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    sc[x] = ex2(fmaf(sc[x], scale_log2, -lse_l[(x >> 1) & 1]));
  }
  if (!whole) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      const int key = k0 + (x >> 2) * 8 + 2 * t + (x & 1);
      sc[x] = (key >= lo[r]) & (key <= hi[r]) ? sc[x] : 0.f;
    }
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    dp[x] = sc[x] * (dp[x] - dc[(x >> 1) & 1]) * scale;
  }
  hopper::acc_to_a(da, dp);
}

// ---- dq: one block per (query head, 192-query tile)

constexpr int kDqWgs = 3;                           // consumer warpgroups
constexpr int kDqBlock = 64 * kDqWgs;               // queries a block
constexpr int kDqConsumers = 128 * kDqWgs;
constexpr int kDqThreads = kDqConsumers + 128;      // and the producer
constexpr int kDqConsumerRegs = 160;  // launched at 128: the producer's 24
                                      // free 32 more for each consumer
constexpr int kDqStages = 4;                        // the copy ring of K, V
constexpr size_t kDqSmem = 1024 + kDqWgs * 2 * kTileBytes +
                           kDqStages * 2 * kTileBytes + 128;   // 113 KB

// Each of three consumer warpgroups owns 64 of the block's queries, with
// its Q and dO tiles in shared memory (the A operands of S = Q K^T and dP =
// dO V^T; in registers they would leave no room for a third warpgroup at
// 160 registers), and all three share the band's 64-key K and V tiles,
// which the producer streams through the ring. A warpgroup first computes
// D = rowsum(do * o) of its rows (and writes it for the dk/dv kernel, so
// no D kernel runs). Per tile: S and dP (4 k steps each), waited for with
// the tile before's dQ, then p, dS = p (dP - D) scale and dQ += dS K (K
// read MN-major), with the next tile's S and dP queued behind dQ; the
// other warpgroups' products run under one's elementwise work. dq
// recomputes S and dP rather than taking dS from the dk/dv kernel: no
// atomics, the same bits on every run.
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_wgmma64_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ dcap,
              __nv_bfloat16* __restrict__ dq, int s, int sk, int ls, int group,
              int causal, int window, int qp, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = aligned_shared(smem_raw);     // Q a warpgroup
  unsigned char* dos = qs + kDqWgs * kTileBytes;    // dO a warpgroup
  unsigned char* ring = dos + kDqWgs * kTileBytes;  // K, V a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDqStages * 2 *
                                               kTileBytes);
  uint64_t* empty = full + kDqStages;
  uint64_t* q_bar = empty + kDqStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // heads fastest: the last query tiles of every head, which visit the
  // most causal key tiles, start first
  const int nq = (s + kDqBlock - 1) / kDqBlock;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kDqBlock;
  const int bh = blockIdx.x;
  int t0, t1;
  key_tiles(q0, min(q0 + kDqBlock, s), sk, kTile, causal, window, qp, &t0, &t1);
  const int items = t1 - t0;

  if (tid == 0) {
    for (int i = 0; i < kDqStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kDqConsumers);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kDqConsumers / 32) {           // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kDqConsumers) {
      const int hk = bh / group;
      hopper::mbar_expect_tx(q_bar, 2 * kDqWgs * kTileBytes);
      for (int w = 0; w < kDqWgs; ++w) {
        load_rows<1>(qs + w * kTileBytes, &tq, q_bar, q0 + 64 * w, bh);
        load_rows<1>(dos + w * kTileBytes, &tdo, q_bar, q0 + 64 * w, bh);
      }
      for (int i = 0; i < items; ++i) {
        const int st = i % kDqStages;
        if (i >= kDqStages) {
          hopper::mbar_wait(empty + st, (i / kDqStages - 1) & 1);
        }
        unsigned char* ks = ring + st * 2 * kTileBytes;
        const int k0 = (t0 + i) * kTile;
        hopper::mbar_expect_tx(full + st, 2 * kTileBytes);
        load_rows<1>(ks, &tk, full + st, k0, hk);
        load_rows<1>(ks + kTileBytes, &tv, full + st, k0, hk);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kDqConsumerRegs>();

  // the warpgroup's index, read from lane 0 so that the compiler knows it
  // is the same in every thread of a warp: the branches that depend on it
  // (the warpgroup's range of items, its masks) then do not count as
  // divergent, and ptxas keeps the wgmma products asynchronous rather than
  // serialising them
  const int wgi = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int g = lane >> 2, t = lane & 3;
  const unsigned char* qt = qs + wgi * kTileBytes;
  const unsigned char* dot = dos + wgi * kTileBytes;
  const int qw0 = q0 + 64 * wgi;                    // this warpgroup's queries
  const int qrow = qw0 + (warp & 3) * 16 + g;       // queries qrow, qrow + 8
  // the block's items [a, b) that this warpgroup's queries see
  int a = 0, b = 0;
  if (qw0 < s) {
    int w0, w1;
    key_tiles(qw0, min(qw0 + 64, s), sk, kTile, causal, window, qp, &w0, &w1);
    a = w0 - t0;
    b = w1 - t0;
  }
  const int64_t qoff = static_cast<int64_t>(bh) * s * kD;
  // D = rowsum(do * o) of this thread's rows, from its dO fragments and the
  // same elements of o, summed over the quad that shares the rows; written
  // for the dk/dv kernel too (0 in the padding rows [s, ls))
  float dc_r[2];
  {
    uint32_t oa[4][4], ob[4][4];
    hopper::rows_to_a64(oa, dout + qoff, qrow, s, t);
    hopper::rows_to_a64(ob, o + qoff, qrow, s, t);
    row_dots(dc_r, oa, ob);
  }
  // the keys [lo, hi] each of this thread's two rows sees (visible_bwd:
  // none for a row past s), lse log2e of the rows
  int lo[2], hi[2];
  float lse_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    hi[r] = row >= s ? -1 : causal ? row + qp : sk - 1;
    lo[r] = window > 0 ? row + qp - window + 1 : 0;
    const int64_t off = static_cast<int64_t>(bh) * ls + row;
    lse_l[r] = row < s ? lse[off] * kLog2e : 0.f;
    if (t == 0 && row < ls) dcap[off] = dc_r[r];
  }
  const float scale_log2 = scale * kLog2e;

  auto stage = [&](int i) { return ring + (i % kDqStages) * 2 * kTileBytes; };
  auto release = [&](int i) { hopper::mbar_arrive(empty + i % kDqStages); };
  // S = Q K^T and dP = dO V^T of tile i, two commit groups
  float sc[32], dp[32];
  auto first_products = [&](int i) {
    const unsigned char* ks = stage(i);
    hopper::mbar_wait(full + i % kDqStages, (i / kDqStages) & 1);
    hopper::wgmma_fence();
    hopper::wgmma_m64n64k16_ss_z(sc, kmajor(qt, 0), kmajor(ks, 0));
#pragma unroll
    for (int kk = 1; kk < kD / 16; ++kk) {
      hopper::wgmma_m64n64k16_ss(sc, kmajor(qt, kk), kmajor(ks, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_m64n64k16_ss_z(dp, kmajor(dot, 0),
                                 kmajor(ks + kTileBytes, 0));
#pragma unroll
    for (int kk = 1; kk < kD / 16; ++kk) {
      hopper::wgmma_m64n64k16_ss(dp, kmajor(dot, kk),
                                 kmajor(ks + kTileBytes, kk), 1);
    }
    hopper::wgmma_commit();
  };

  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;
  for (int i = 0; i < a; ++i) {              // tiles only the other sees
    hopper::mbar_wait(full + i % kDqStages, (i / kDqStages) & 1);
    release(i);
  }
  uint32_t da[4][4];
  hopper::mbar_wait(q_bar, 0);
  if (a < b) first_products(a);
  for (int i = a; i < b; ++i) {
    const unsigned char* ks = stage(i);
    const int k0 = (t0 + i) * kTile;
    // tile i's S and dP, and the tile before's dQ, are done (as dk/dv's)
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    if (i > a) release(i - 1);
    // p, 0 where masked (a tile the band covers whole needs no mask), then
    // dS = p (dP - D) scale
    const bool whole = qw0 + 64 <= s && k0 + kTile <= sk &&
                       (!causal || k0 + kTile - 1 <= qw0 + qp) &&
                       (window <= 0 || qw0 + qp + 63 - window < k0);
    tile_ds(da, sc, dp, k0, whole, lo, hi, lse_l, dc_r, t, scale_log2, scale);
    hopper::fence_regs(da);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {       // dQ += dS K
      hopper::wgmma_m64n64k16_rs_tb(acc, da[kk], mnmajor(ks, kk), 1);
    }
    hopper::wgmma_commit();
    if (i + 1 < b) first_products(i + 1);   // queued behind dQ
  }
  if (a < b) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    release(b - 1);
  }
  for (int i = b; i < items; ++i) {
    hopper::mbar_wait(full + i % kDqStages, (i / kDqStages) & 1);
    release(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + r * 8;
    if (row >= s) continue;
    __nv_bfloat16* out = dq + qoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---- dq, the short form (sk <= kShortKeys): one block per (query head,
// part of its 64-query tiles), the head's K and V resident whole

// K and V of every tile, Q and dO a (warpgroup, buffer), the barriers and
// one tile's D
constexpr size_t kDqShortSmem = 1024 + 2 * kShortTiles * kTileBytes +
                                kDqWgs * 2 * 2 * kTileBytes + 256 +
                                kTile * sizeof(float);      // 226 KB

// The long form reads a head's K and V again for every 192 queries, and at
// a short key length its grid runs in waves with a tail (seamless's cross-
// attention: 352 blocks of 8 key tiles each for 132 SMs; its encoder: 48
// blocks). Here a block loads the head's 64-key K and V tiles once, each on
// a barrier of its own (a tile's products wait for that tile only), and its
// three consumer warpgroups walk the part's 64-query items: item i goes to
// warpgroup i % 3, whose Q and dO come through two buffers, so the next
// item's copy is in flight while this one computes. Parts are chosen so
// that the grid is about one block an SM. Each item is the long form's
// warpgroup walk: D of its rows (written for the dk/dv kernel), then the
// same key tiles in the same order with the same arithmetic, so dq and D
// keep their bits whichever form runs. A part of one query tile (an
// encoder's 8 tiles a head over 16 heads: 128 parts) would leave two of
// the three warpgroups idle and walk all eight key tiles in turn; there
// the warpgroups share the tile's key tiles and add their dQ through
// shared memory in a fixed order (dq's bits then differ from the long
// form's; D's do not).
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_wgmma64_short_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ dcap,
              __nv_bfloat16* __restrict__ dq, int s, int sk, int ls, int group,
              int causal, int window, int qp, float scale, int per) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kts = aligned_shared(smem_raw);    // K of tile j
  unsigned char* vts = kts + kShortTiles * kTileBytes;        // V of tile j
  unsigned char* qbuf = vts + kShortTiles * kTileBytes;       // Q, dO
  uint64_t* kfull = reinterpret_cast<uint64_t*>(qbuf + kDqWgs * 2 * 2 *
                                                kTileBytes);
  uint64_t* vfull = kfull + kShortTiles;
  uint64_t* q_full = vfull + kShortTiles;           // [warpgroup][buffer]
  uint64_t* q_empty = q_full + kDqWgs * 2;
  float* dc_s = reinterpret_cast<float*>(kfull + 32);  // a spread tile's D

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int nt = (s + kTile - 1) / kTile;
  const int first = static_cast<int>(blockIdx.y) * per;
  const int cnt = max(0, min(per, nt - first));
  // the key tiles any query of the part sees
  int t0, t1;
  key_tiles(first * kTile, min((first + cnt) * kTile, s), sk, kTile, causal,
            window, qp, &t0, &t1);

  if (tid == 0) {
    for (int j = 0; j < kShortTiles; ++j) {
      hopper::mbar_init(kfull + j, 1);
      hopper::mbar_init(vfull + j, 1);
    }
    for (int i = 0; i < kDqWgs * 2; ++i) {
      hopper::mbar_init(q_full + i, 1);
      hopper::mbar_init(q_empty + i, 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kDqConsumers / 32) {           // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kDqConsumers && cnt > 0) {
      const int hk = bh / group;
      auto load_kv = [&](int j) {
        hopper::mbar_expect_tx(kfull + j, kTileBytes);
        load_rows<1>(kts + j * kTileBytes, &tk, kfull + j, j * kTile, hk);
        hopper::mbar_expect_tx(vfull + j, kTileBytes);
        load_rows<1>(vts + j * kTileBytes, &tv, vfull + j, j * kTile, hk);
      };
      // item i: warpgroup i % 3, its (i / 3)-th item, buffer (i / 3) & 1
      auto load_q = [&](int i) {
        const int n = i / kDqWgs, slot = (i % kDqWgs) * 2 + (n & 1);
        if (n >= 2) hopper::mbar_wait(q_empty + slot, ((n >> 1) - 1) & 1);
        unsigned char* qt = qbuf + slot * 2 * kTileBytes;
        hopper::mbar_expect_tx(q_full + slot, 2 * kTileBytes);
        load_rows<1>(qt, &tq, q_full + slot, (first + i) * kTile, bh);
        load_rows<1>(qt + kTileBytes, &tdo, q_full + slot,
                     (first + i) * kTile, bh);
      };
      // in the order the walks need them: the first item's Q, dO and first
      // key tile, the other warpgroups' first items, the other key tiles,
      // then each warpgroup's later items as their buffers come free
      const int lead = min(cnt, kDqWgs);
      load_q(0);
      if (t0 < t1) load_kv(t0);
      for (int i = 1; i < lead; ++i) load_q(i);
      for (int j = t0 + 1; j < t1; ++j) load_kv(j);
      for (int i = lead; i < cnt; ++i) load_q(i);
    }
    return;
  }
  hopper::setmaxnreg_inc<kDqConsumerRegs>();

  // the warpgroup's index through a shuffle, as the long form's
  const int wgi = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  float acc[32];
  // a part of one item: the three warpgroups share its key tiles (tile a +
  // w, a + w + 3, ... to warpgroup w), and warpgroup 0 adds the others' dQ
  // in warpgroup order (the long form's order of adds is lost, the bits
  // still repeat); else item i of the part goes to warpgroup i % 3
  const bool spread = cnt == 1;
  for (int n = 0; spread ? n < 1 : wgi + kDqWgs * n < cnt; ++n) {
    const int slot = spread ? 0 : wgi * 2 + (n & 1);
    const unsigned char* qt = qbuf + slot * 2 * kTileBytes;
    const unsigned char* dot = qt + kTileBytes;
    const int qw0 = (first + (spread ? 0 : wgi + kDqWgs * n)) * kTile;
    const int qrow = qw0 + (warp & 3) * 16 + g;       // queries qrow, qrow + 8
    int a, b;                                         // its key tiles
    key_tiles(qw0, min(qw0 + 64, s), sk, kTile, causal, window, qp, &a, &b);
    const int64_t qoff = static_cast<int64_t>(bh) * s * kD;
    // D = rowsum(do * o) of this thread's rows, as the long form's (the
    // same values in the same order: dO from its tile in shared memory, o
    // from global memory); in spread mode warpgroup 0 hands it to the
    // others through shared memory
    float dc_r[2] = {0.f, 0.f};
    if (!spread || wgi == 0) {
      uint32_t oa[4][4], ob[4][4];
      hopper::rows_to_a64(ob, o + qoff, qrow, s, t);
      hopper::mbar_wait(q_full + slot, (n >> 1) & 1);
      hopper::tile_to_a64(oa, dot, qrow - qw0, t);
      row_dots(dc_r, oa, ob);
    }
    int lo[2], hi[2];
    float lse_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      hi[r] = row >= s ? -1 : causal ? row + qp : sk - 1;
      lo[r] = window > 0 ? row + qp - window + 1 : 0;
      const int64_t off = static_cast<int64_t>(bh) * ls + row;
      lse_l[r] = row < s ? lse[off] * kLog2e : 0.f;
      if (t == 0 && (!spread || wgi == 0)) {
        if (row < ls) dcap[off] = dc_r[r];
        if (spread) dc_s[row - qw0] = dc_r[r];
      }
    }
    if (spread && wgi == 0) hopper::named_arrive(2, kDqConsumers);

    // per key tile: S = Q K^T and dP = dO V^T (two commit groups, queued
    // behind the tile before's dQ), waited for with that dQ, then p, dS =
    // p (dP - D) scale and dQ += dS K (K read MN-major). S and dP are
    // declared in the loop body and issued at its top: issued at the
    // bottom, for the next tile, into accumulators the loop carries (the
    // long forms' order), they make ptxas serialise every wgmma product of
    // the kernel (its C7515 note)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] = 0.f;
    hopper::mbar_wait(q_full + slot, (n >> 1) & 1);
    const int step = spread ? kDqWgs : 1;
    bool need_dc = spread && wgi != 0;
    for (int i = a + (spread ? wgi : 0); i < b; i += step) {
      const unsigned char* kt = kts + i * kTileBytes;
      const unsigned char* vt = vts + i * kTileBytes;
      const int k0 = i * kTile;
      float sc[32], dp[32];
      hopper::mbar_wait(kfull + i, 0);
      hopper::mbar_wait(vfull + i, 0);
      hopper::wgmma_fence();
      hopper::wgmma_m64n64k16_ss_z(sc, kmajor(qt, 0), kmajor(kt, 0));
#pragma unroll
      for (int kk = 1; kk < kD / 16; ++kk) {
        hopper::wgmma_m64n64k16_ss(sc, kmajor(qt, kk), kmajor(kt, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_m64n64k16_ss_z(dp, kmajor(dot, 0), kmajor(vt, 0));
#pragma unroll
      for (int kk = 1; kk < kD / 16; ++kk) {
        hopper::wgmma_m64n64k16_ss(dp, kmajor(dot, kk), kmajor(vt, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::fence_regs(acc);
      if (need_dc) {                          // warpgroup 0's D, once
        hopper::named_sync(2, kDqConsumers);
#pragma unroll
        for (int r = 0; r < 2; ++r) dc_r[r] = dc_s[qrow + 8 * r - qw0];
        need_dc = false;
      }
      const bool whole = qw0 + 64 <= s && k0 + kTile <= sk &&
                         (!causal || k0 + kTile - 1 <= qw0 + qp) &&
                         (window <= 0 || qw0 + qp + 63 - window < k0);
      uint32_t da[4][4];
      tile_ds(da, sc, dp, k0, whole, lo, hi, lse_l, dc_r, t, scale_log2,
              scale);
      hopper::fence_regs(da);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {       // dQ += dS K
        hopper::wgmma_m64n64k16_rs_tb(acc, da[kk], mnmajor(kt, kk), 1);
      }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (need_dc) hopper::named_sync(2, kDqConsumers);   // walked no tile
    if (spread) {
      // warpgroups 1 and 2 leave their dQ in their own Q buffers, which
      // this mode does not load, thread by thread
      const int ct = tid & 127;
      if (wgi != 0) {
        float4* mine = reinterpret_cast<float4*>(qbuf + wgi * 4 * kTileBytes);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mine[j * 128 + ct] = make_float4(acc[4 * j], acc[4 * j + 1],
                                           acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      hopper::named_sync(1, kDqConsumers);
      if (wgi != 0) break;
      for (int w = 1; w < kDqWgs; ++w) {
        const float4* theirs =
            reinterpret_cast<const float4*>(qbuf + w * 4 * kTileBytes);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 x = theirs[j * 128 + ct];
          acc[4 * j] += x.x;
          acc[4 * j + 1] += x.y;
          acc[4 * j + 2] += x.z;
          acc[4 * j + 3] += x.w;
        }
      }
    } else {
      hopper::mbar_arrive(q_empty + slot);    // Q and dO are read
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + r * 8;
      if (row >= s) continue;
      __nv_bfloat16* out = dq + qoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + j * 8) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
  // key tiles no walk of this warpgroup read land before the block exits
  for (int j = t0; cnt > 0 && j < t1; ++j) {
    hopper::mbar_wait(kfull + j, 0);
    hopper::mbar_wait(vfull + j, 0);
  }
}

}  // namespace wg64

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
  int s, sk, ls, group, causal, window, qp;
  float scale;
  cudaStream_t stream;
};

// bf16 at D = 64, 128 and 256 takes the wgmma kernels, bf16 at every other
// D the mma.sync kernels, f32 the FMA kernels
// o and a writable dcap reach the D = 64 kernel, which forms D itself
template <int D>
int launch_dq(int dtype, const Args& a, long long bh, const void* o,
              void* dcap, void* dq) {
  if (dtype == 2) {
    if constexpr (D == wg256::kD) {
      wg::Maps m;
      const int pairs = (a.group + 1) / 2;
      int rc = wg::make_maps(&m, a.q, a.k, a.v, a.dout, bh, bh / a.group,
                             a.s, a.sk, wg256::kD);
      if (rc == 0) {
        rc = set_smem(wg256::flash_bwd_dq_wgmma256_kernel, wg256::kDqSmem);
      }
      if (rc != 0) return rc;
      const dim3 grid(static_cast<unsigned>(bh / a.group * pairs),
                      (a.s + wg::kTile - 1) / wg::kTile);
      wg256::flash_bwd_dq_wgmma256_kernel<<<grid, wg256::kThreads256,
                                            wg256::kDqSmem, a.stream>>>(
          m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.dcap), static_cast<__nv_bfloat16*>(dq),
          a.s, a.sk, a.ls, a.group, pairs, a.causal, a.window, a.qp, a.scale);
      return static_cast<int>(cudaGetLastError());
    } else if constexpr (D == wg64::kD) {
      wg::Maps m;
      int rc = wg::make_maps(&m, a.q, a.k, a.v, a.dout, bh, bh / a.group,
                             a.s, a.sk, D);
      if (rc == 0 && a.sk <= wg64::kShortKeys) {
        // parts of a head's 64-query tiles: about one block an SM in all
        int sms = 0;
        rc = sm_count(&sms);
        if (rc == 0) {
          rc = set_smem(wg64::flash_bwd_dq_wgmma64_short_kernel,
                        wg64::kDqShortSmem);
        }
        if (rc != 0) return rc;
        const int nt = (a.s + wg::kTile - 1) / wg::kTile;
        const int parts = static_cast<int>(std::max<long long>(
            1, std::min<long long>(nt, sms / bh)));
        const int per = (nt + parts - 1) / parts;
        const dim3 grid(static_cast<unsigned>(bh), (nt + per - 1) / per);
        wg64::flash_bwd_dq_wgmma64_short_kernel<<<grid, wg64::kDqThreads,
                                                  wg64::kDqShortSmem,
                                                  a.stream>>>(
            m.q, m.dout, m.k, m.v, static_cast<const __nv_bfloat16*>(o),
            static_cast<const __nv_bfloat16*>(a.dout),
            static_cast<const float*>(a.lse), static_cast<float*>(dcap),
            static_cast<__nv_bfloat16*>(dq), a.s, a.sk, a.ls, a.group,
            a.causal, a.window, a.qp, a.scale, per);
        return static_cast<int>(cudaGetLastError());
      }
      if (rc == 0) {
        rc = set_smem(wg64::flash_bwd_dq_wgmma64_kernel, wg64::kDqSmem);
      }
      if (rc != 0) return rc;
      const dim3 grid(static_cast<unsigned>(bh),
                      (a.s + wg64::kDqBlock - 1) / wg64::kDqBlock);
      wg64::flash_bwd_dq_wgmma64_kernel<<<grid, wg64::kDqThreads,
                                          wg64::kDqSmem, a.stream>>>(
          m.q, m.dout, m.k, m.v,
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<float*>(dcap),
          static_cast<__nv_bfloat16*>(dq), a.s, a.sk, a.ls, a.group, a.causal,
          a.window, a.qp, a.scale);
      return static_cast<int>(cudaGetLastError());
    } else if constexpr (D == wg::kD) {
      wg::Maps m;
      int rc = wg::make_maps(&m, a.q, a.k, a.v, a.dout, bh,
                             bh / a.group, a.s, a.sk);
      if (rc == 0) rc = set_smem(wg::flash_bwd_dq_wgmma_kernel, wg::kDqSmem);
      if (rc != 0) return rc;
      const dim3 grid(static_cast<unsigned>(bh),
                      (a.s + wg::kTile - 1) / wg::kTile);
      wg::flash_bwd_dq_wgmma_kernel<<<grid, wg::kDqThreads, wg::kDqSmem,
                                      a.stream>>>(
          m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.dcap), static_cast<__nv_bfloat16*>(dq),
          a.s, a.sk, a.ls, a.group, a.causal, a.window, a.qp, a.scale);
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
          static_cast<__nv_bfloat16*>(dq), a.s, a.sk, a.ls, a.group, a.causal,
          a.window, a.qp, a.scale);
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
        static_cast<float*>(dq), a.s, a.sk, a.ls, a.group, a.causal, a.window,
        a.qp, a.scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// splits > 1 for bf16 at D = 256: the dk/dv kernel writes f32 partials into
// ws [2, splits, bkv, s, 256] (splits <= the GQA group), and the split
// reduce sums them into dk and dv; for bf16 at D = 64 and sk <= kShortKeys
// (the short form, always taken there): clusters of `splits` blocks
// (splits <= kMaxSplits) add their partials through shared memory, no ws
template <int D>
int launch_dkv(int dtype, const Args& a, long long bkv, void* dk, void* dv,
               void* ws, int splits) {
  const bool wide = dtype == 2 && D == wg256::kD;
  const bool short_keys =
      dtype == 2 && D == wg64::kD && a.sk <= wg64::kShortKeys;
  if (splits < 1 || (splits > 1 && !wide && !short_keys) ||
      (wide && splits > 1 && (splits > a.group || ws == nullptr)) ||
      (short_keys &&
       (splits > wg64::kMaxSplits || (splits & (splits - 1)) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 2) {
    if constexpr (D == wg256::kD) {
      wg::Maps m;
      int rc = wg::make_maps(&m, a.q, a.k, a.v, a.dout, bkv * a.group,
                             bkv, a.s, a.sk, wg256::kD);
      if (rc == 0) {
        rc = set_smem(wg256::flash_bwd_dkv_wgmma256_kernel, wg256::kDkvSmem);
      }
      if (rc != 0) return rc;
      const dim3 grid(static_cast<unsigned>(bkv * splits),
                      (a.sk + wg::kTile - 1) / wg::kTile);
      wg256::flash_bwd_dkv_wgmma256_kernel<<<grid, wg256::kThreads256,
                                             wg256::kDkvSmem, a.stream>>>(
          m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.dcap), static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), static_cast<float*>(ws), a.s, a.sk,
          a.ls,
          a.group, splits, a.causal, a.window, a.qp, a.scale);
      rc = static_cast<int>(cudaGetLastError());
      if (rc != 0 || splits == 1) return rc;
      const long long n = bkv * a.sk * wg256::kD;
      const long long blocks = (n / 4 + 255) / 256;
      const dim3 rgrid(static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                       2);
      wg256::flash_bwd_split_reduce_kernel<<<rgrid, 256, 0, a.stream>>>(
          static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), n, splits);
      return static_cast<int>(cudaGetLastError());
    } else if constexpr (D == wg64::kD) {
      CUtensorMap tq, tdo;
      int rc = hopper::tensor_map_bf16(&tq, a.q, D, a.s, bkv * a.group,
                                       kTile);
      if (rc == 0) {
        rc = hopper::tensor_map_bf16(&tdo, a.dout, D, a.s, bkv * a.group,
                                     kTile);
      }
      const dim3 grid(static_cast<unsigned>(bkv * splits),
                      (a.sk + wg64::kBlock - 1) / wg64::kBlock);
      const auto* k = static_cast<const __nv_bfloat16*>(a.k);
      const auto* v = static_cast<const __nv_bfloat16*>(a.v);
      const auto* lse = static_cast<const float*>(a.lse);
      const auto* dcap = static_cast<const float*>(a.dcap);
      auto* dkp = static_cast<__nv_bfloat16*>(dk);
      auto* dvp = static_cast<__nv_bfloat16*>(dv);
      if (short_keys) {
        // the cluster of a (KV head, key tile)'s splits: its blocks are
        // neighbours in x
        if (rc == 0) {
          rc = set_smem(wg64::flash_bwd_dkv_wgmma64_kernel<true>,
                        wg64::kDkvSplitSmem);
        }
        if (rc != 0) return rc;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(wg64::kThreads64);
        cfg.dynamicSmemBytes = wg64::kDkvSplitSmem;
        cfg.stream = a.stream;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        return static_cast<int>(cudaLaunchKernelEx(
            &cfg, wg64::flash_bwd_dkv_wgmma64_kernel<true>, k, v, tq, tdo,
            lse, dcap, dkp, dvp, a.s, a.sk, a.ls, a.group, a.causal,
            a.window, a.qp, a.scale, splits));
      }
      if (rc == 0) {
        rc = set_smem(wg64::flash_bwd_dkv_wgmma64_kernel<false>,
                      wg64::kDkvSmem);
      }
      if (rc != 0) return rc;
      wg64::flash_bwd_dkv_wgmma64_kernel<false><<<grid, wg64::kThreads64,
                                                  wg64::kDkvSmem, a.stream>>>(
          k, v, tq, tdo, lse, dcap, dkp, dvp, a.s, a.sk, a.ls, a.group,
          a.causal, a.window, a.qp, a.scale, 1);
      return static_cast<int>(cudaGetLastError());
    } else if constexpr (D == wg::kD) {
      wg::Maps m;
      int rc = wg::make_maps(&m, a.q, a.k, a.v, a.dout, bkv * a.group, bkv,
                             a.s, a.sk);
      if (rc == 0) rc = set_smem(wg::flash_bwd_dkv_wgmma_kernel, wg::kDkvSmem);
      if (rc != 0) return rc;
      const dim3 grid(static_cast<unsigned>(bkv),
                      (a.sk + wg::kTile - 1) / wg::kTile);
      wg::flash_bwd_dkv_wgmma_kernel<<<grid, wg::kDkvThreads, wg::kDkvSmem,
                                       a.stream>>>(
          m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.dcap), static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), a.s, a.sk, a.ls, a.group, a.causal,
          a.window, a.qp, a.scale);
      return static_cast<int>(cudaGetLastError());
    } else {
      constexpr size_t smem = mma_smem<D>();
      const int rc = set_smem(flash_bwd_dkv_mma_kernel<D>, smem);
      if (rc != 0) return rc;
      const dim3 grid((a.sk + kTile - 1) / kTile, static_cast<unsigned>(bkv));
      flash_bwd_dkv_mma_kernel<D><<<grid, kThreads, smem, a.stream>>>(
              static_cast<const __nv_bfloat16*>(a.q),
              static_cast<const __nv_bfloat16*>(a.k),
              static_cast<const __nv_bfloat16*>(a.v),
              static_cast<const __nv_bfloat16*>(a.dout),
              static_cast<const float*>(a.lse),
              static_cast<const float*>(a.dcap),
              static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
              a.s, a.sk, a.ls, a.group, a.causal, a.window, a.qp, a.scale);
    }
  } else if (dtype == 0) {
    constexpr size_t smem = f32_smem<D>();
    const int rc = set_smem(flash_bwd_dkv_f32_kernel<D>, smem);
    if (rc != 0) return rc;
    const dim3 grid((a.sk + kF32Rows - 1) / kF32Rows,
                    static_cast<unsigned>(bkv));
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dcap),
        static_cast<float*>(dk), static_cast<float*>(dv), a.s, a.sk, a.ls,
        a.group,
        a.causal, a.window, a.qp, a.scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the checks both entry points make; fills a and returns 0, or an error
int prepare(Args* a, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* dcap,
            long long bh, long long bkv, int s, int sk, int d, int ls,
            int causal, int window, int q_pos0, void* stream) {
  if (bkv <= 0 || bh % bkv != 0 || bh > 65535 || ls < s || ls % 64 != 0 ||
      sk <= 0 || !offset_ok(s, sk, causal, window, q_pos0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *a = Args{q, k, v, dout, lse, dcap, s, sk, ls, static_cast<int>(bh / bkv),
            causal, window, q_pos0,
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

// q, o, do [bh, s, d]; k, v [bkv, sk, d]; lse and dcap = rowsum(do * o)
// [bh, ls] f32 (rows padded to ls, a multiple of 64, ls >= s; dcap written
// by repro_flash_bwd_dq); dq [bh, s, d]; dk, dv [bkv, sk, d]; all
// contiguous and 16-byte aligned. dtype: 0 = float32, 2 = bfloat16 (q, k,
// v, do and the outputs share it). window <= 0: no window. sk, the key
// length, is s for self-attention; q_pos0, the causal query offset, as
// repro_flash_fwd's (offset_ok: a cross-attention's sk of its own takes
// neither a causal mask nor a window). d in {16, 32, 64, 96, 128, 256}.
// splits: the dk/dv grid's split of each GQA group (1, or for bf16 at d =
// 256 up to bh / bkv, with ws an f32 workspace [2, splits, bkv, sk, d]).
// The dq entry point writes dcap = rowsum(do * o) from o (the forward's
// output, q's type) with a kernel of its own before the dq kernel, or at d
// = 64 in bf16 inside the dq kernel; the dk/dv entry point reads that
// dcap, so it runs after this one on the same stream.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* dcap, void* dq,
                                  int dtype, long long bh, long long bkv,
                                  int s, int sk, int d, int ls, int causal,
                                  int window, int q_pos0, void* stream) {
  Args a;
  const int rc = prepare(&a, q, k, v, dout, lse, dcap, bh, bkv, s, sk, d,
                         ls, causal, window, q_pos0, stream);
  if (rc != 0) return rc;
  if (bh == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  const dim3 dgrid((ls + kThreads / 32 - 1) / (kThreads / 32),
                   static_cast<unsigned>(bh));
  if (dtype != 0 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    flash_bwd_dcap_kernel<<<dgrid, kThreads, 0, a.stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(dcap), s, ls, d);
  } else if (d != wg64::kD) {             // at d = 64 the dq kernel writes it
    flash_bwd_dcap_kernel<<<dgrid, kThreads, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(dcap),
        s, ls, d);
  }
#define REPRO_DQ(D) launch_dq<D>(dtype, a, bh, o, dcap, dq)
  REPRO_FLASH_BWD_DISPATCH(REPRO_DQ)
#undef REPRO_DQ
}

extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dcap,
                                   void* dk, void* dv, void* ws, int splits,
                                   int dtype, long long bh, long long bkv,
                                   int s, int sk, int d, int ls, int causal,
                                   int window, int q_pos0, void* stream) {
  Args a;
  const int rc = prepare(&a, q, k, v, dout, lse, dcap, bh, bkv, s, sk, d,
                         ls, causal, window, q_pos0, stream);
  if (rc != 0) return rc;
  if (bh == 0 || s == 0) return static_cast<int>(cudaGetLastError());
#define REPRO_DKV(D) launch_dkv<D>(dtype, a, bkv, dk, dv, ws, splits)
  REPRO_FLASH_BWD_DISPATCH(REPRO_DKV)
#undef REPRO_DKV
}
